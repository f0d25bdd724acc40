#!/usr/bin/env python3
"""Drive the PyTorch port's bbop main path once on one CUDA card.

    python3 chip_smoke.py [--json PATH] [--trace PATH]

Run from a checkout; it puts the checkout's ``src/`` and ``experiments/``
on ``sys.path`` itself, reads ``BENCH_apps.json`` and
``BENCH_serving.json``, loads ``scripts/check_trace.py`` and the
``examples_torch/`` files by path and imports only ``repro_torch`` and
``popmma_probe`` (no JAX).  Phase 9c's
Chrome trace goes to ``--trace`` (default
``build/serving_channel_trace.json``).  Phases, one line each:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a)
     and print the ptxas register / shared-memory / spill lines;
  2. K1/K2: transpose 1,048,576 random lanes at 8, 16 and 32 planes; the
     round trip is exact and each kernel equals its plain version bit for
     bit (K2 signed and unsigned); each width's wrapper time, bare-launch
     time (CUDA events), host time per launch and kernel-only time
     (``torch.profiler``);
  3. the fast path: ``SimdramDevice(backend="cuda").bbop`` for all 16 ops
     at 8 bits and addition/multiplication/greater at 16 bits, at
     ``DDR4.simd_lanes`` lanes, checked against each op's oracle, plus
     one ``backend="bitplane"`` call; then K3 against the plain circuit,
     and K1 and K2 against theirs at each op's operand and output
     widths, with each op's times as in phase 2 and its program's gates,
     levels, slots and warps (the ``bitplane`` call's K3 launch repeats
     addition/8's at its shape, so 19 comparisons cover 20 launches);
     K3's outputs also equal ``kernels.ref.elementwise_circuit_ref``
     (the eager ``bitplane`` backend on the CPU), lane for lane;
  4. the slice: ``SimdramDevice(backend="bank").dispatch`` of the mix and
     chain queues of ``benchmarks/bank_scaling.py`` at 65,536 lanes per
     instruction, checked against the numpy oracle, with 5 K5 launches;
     K1 on the chain's entry operand and K2 on its vertical results
     against their plain versions; then each of the mix queue's fused
     waves through K5 (with the wave's cached schedule) and through the
     plain replay, and the chain queue's waves of a repeat of its
     dispatch likewise; each mix wave's device
     time, longest real command count and time per command, and a
     repeat of both dispatches under ``torch.profiler`` (host wall,
     device time by kernel and copy, the device's idle share);
  5. the bit-serial matmul (K4): ``bitserial_matmul`` of 2-bit unsigned
     activations by 2-bit signed weights at the im2col shapes of three
     VGG-16 layers at 224 x 224, one fused K4 launch each, checked against
     exact integer oracles, plus a 1 x 1-bit and a 4 x 4-bit
     ``quantized_matmul`` (both branches); then the binary MAC rate of
     each unit K4 could run on (``experiments/popmma_probe.py``, built in
     phase 1), of which the fastest sets K4's bound; then at each shape
     K4's fused product against its plain version and ``torch._int_mm``
     on the 2-bit values, and one binary product against
     ``torch._int_mm`` on the bits; every K4 launch of the path has its
     twin compared with the plain version;
  6. the fault path (K6): ``SimdramDevice(backend="bank", fault=...)``
     over the mix queue at 32,768 logical lanes (two replicas fill each
     unit's 65,536 columns) at the paper's sigma = 0.15, checked against
     the fault-free dispatch and the oracle (lanes whose replicas were
     corrupted alike are counted and bounded, see ``WRONG_LANE_SHARE``,
     and its wrong lanes and K6 launches must be those of ``SIGMA_SEED0``);
     a dead-unit run that must heal exactly by blacklisting; a
     stuck-column run with 1e-3 flips that must exhaust every unit as the
     reference does, or return exact results; K6
     against its plain version bit for bit on every attempt of the sigma
     run and on every wave with all three failure modes; a disabled
     model launches no K6;
  7. the ladder at full width (``DDR4``, 65,536 columns a subarray, 16
     banks a chip): ``SimdramDevice(backend="chip")`` (16 units),
     ``backend="channel"`` with 8 chips (128 units) and ``backend="rank"``
     with 2 channels of 8 chips (256 units) each dispatch the mix queue
     with two instructions a unit and the chain queue at 65,536 lanes an
     instruction, and run one ``bbop`` over all their lanes; every result
     equals the oracle and the tier's ``sequential_*`` baseline, and each
     stacked round is one K5 launch.  Per tier: first and warm wall, pack
     wall, table-cache hits, misses and bytes, the card's busy time and
     idle share and host-to-device copies (profiler), each round's K5
     kernel time beside its bound, and the modeled latency and transfer
     fields.  Every round of a repeat of the counted run (its twin) goes
     through K5 and the plain replay, which must agree bit for bit, and
     K1 and K2 of the chain queue are held against theirs.  Then the
     fault wrappers on the chip and a 2-chip channel: sigma 0.15 with
     two replicas (wrong lanes bounded as in phase 6), dead units and
     sparse stuck columns (both exact), one K6 launch per attempt of a
     round, and K6 against its plain version, states and flip counts,
     on every attempt of the three runs;
  8. the seven paper apps (``src/repro_torch/apps``) on the rungs
     ``bitplane``, ``cuda``, ``bank``, ``chip`` and ``channel``: (8a) at
     ``benchmarks/paper_tables.py``'s "smoke" sizes and configuration,
     card ``==`` the same run with ``torch_device="cpu"`` (outputs,
     result dicts, totals, modeled engine stats), and ``==``
     ``BENCH_apps.json`` on every integer field, its floats within a
     relative 1e-12 (they were summed in another order); ``cuda`` ``==``
     ``bitplane``; (8b) at its "full" sizes on 16 banks x 2 subarrays x
     4 chips, every app verified and bit-equal on all five rungs, with
     first and warm walls, packing, launches, rounds, table-cache hits
     and misses and the modeled latency and energy; (8c) TPC-H Q6 over
     the 6,001,215 lineitem rows of scale factor 1 on the same
     configuration, the revenue equal to numpy on every rung, plus a
     profiled repeat on the fused rungs (busy time, idle share,
     host-to-device copies, K5 time) and K5 per round beside its bound.
     Every app run on the card is counted, then repeated as its twin:
     each K1, K2, K3 and K5 launch of the repeat is held against the
     plain version on the same inputs, bit for bit, one twin per launch
     of the counted run (the ``apps`` path of each kernel's agreement);
  9. the serving front-end (``src/repro_torch/serving``): (9a) a
     ``ServingFrontend`` over phase 7's 8-chip channel (128 units) serves
     ``benchmarks/serving_soak.py``'s traffic at full width: three
     tenants, its eight ops at 8 and 16 bits, requests of 65,536 lanes,
     4 windows of 16 (a queue of 12, so each overflows; every fourth
     request with the tight deadline, every fifth at priority 1); every
     admitted ticket resolves exactly once, every completed one equals
     the host oracle, each window is one K5 launch a super-round, and a
     warm repeat, the same traffic on the CPU and the same traffic on the
     worker thread (traced, on the main thread's stream) give the same
     stats, ticket values, ``resolved_s`` and ``serving.*`` registry;
     per window the first and warm walls, packing, K5 launches and K5
     time beside its bound, the card's busy time and idle share, and the
     modeled p50, p99 and goodput; (9b) a sigma 0.15 window on the 2-chip
     faulty channel (stuck lanes 0.002, seed 21; wrong lanes bounded as
     in phase 6; requests of 2,048 lanes, so that a window coalesced and
     replicated fits the 65,536 columns the stuck pattern spans) and the
     soak's breaker scenario (trip, shed, half-open,
     recover), whose counts and registry equal ``BENCH_serving.json``'s,
     one K6 launch per attempt; (9c) one full-width dispatch of phase 7's
     mix queue untraced and under the tracer: equal results and
     launches, ``channel.replay`` and ``channel.transfer.*`` ``==`` their
     ``ChannelStats`` fields (the banks' transpose charges, which the
     channel mirrors in another order, within a relative 1e-12),
     each ``channel.replay`` span's ``device_s`` beside the profiler's
     K5 time for its round (printed, with how many rounds differ by more
     than 5 % plus ``DEVICE_S_SLACK_MS``), the tracer's overhead as the
     difference of the warm walls, and its Chrome trace (written to
     ``--trace``) passes ``scripts/check_trace.py``.  Every K5 and K6 launch of
     9a and 9b has its twin through the plain version (the ``serving``
     and ``serving faults`` paths);
 10. the LM stack (``src/repro_torch/models``, ``train/serve.py``), after
     the earlier phases' device memory is released and what is free is
     printed: (10a) every arch of ``configs/`` at ``smoke_config`` in
     float32, ``lm_forward`` (logits, aux) and two decode steps (logits,
     caches) on the card within ``LM_TOL`` (rtol and atol) of the CPU run
     of the same weights, greedy tokens under the margin rule, with the
     int8 KV cache (entries within 1), ``quantize_tree``'d weights and
     the PuM MLP (``tests/test_system.py::test_pum_offload_inside_lm``'s
     configuration: the relu a bbop, one K3 launch a layer, each held
     against the plain circuit); (10b) yi-6b at its published width in
     bf16, ``LM_LAYERS`` of its 32 layers, initialized on the card
     (``param_count()`` equal), a
     ``Server`` of 4 slots x 4,096 positions serving a burst of six
     requests with and without ``PumServeOffload`` on a 4-bank x
     2-subarray chip: every request completes, every step's offload
     returns the very logits it was given (the default stages are a grid
     no-op) and ``offload.reference``'s, its K5 launches equal the chip's
     stacked rounds, every K5 launch is held against the plain replay
     (stacked by state shape), and, under deterministic algorithms,
     every step's logits and every token equal the plain server's bit
     for bit; the model step and offload medians, tokens/s, a profiled burst (idle
     share) and the step's weight-bytes bound; (10c) ``lm_forward`` over
     one prompt of ``LM_PREFILL_LEN`` tokens (what ``make_prefill``
     runs) against the decode logits of every position, and
     ``make_prefill``'s own output against the last, within
     ``LM_BF16_REL`` of each position's max|logit|, greedy tokens under
     the margin rule, and two faults planted into the decode (a dropped
     cache write, every step a position late) must read more than
     ``LM_BF16_REL``; ``make_prefill``'s time beside its FLOP bound and
     ``torch.cuda.max_memory_allocated`` (the ``lm`` path of K3 and K5);
 12. the trainer (``src/repro_torch/train``, ``launch/train.py``), run
     after phase 10 and before the kernels line, once phase 10's model
     is released: (12a) every arch at ``smoke_config`` in float32, two
     ``make_train_step`` steps on the card against the CPU run of the
     same weights and batches (no TF32), each step's loss, aux and grad
     norm and every final parameter within ``LM_TOL``; yi-6b in two
     microbatches; the PuM relu MLP (phase 10a's configuration), its
     relu a K3 launch in every forward and recompute, each held against
     the plain circuit; ``compressed_grad_transform`` over one gradient
     tree, card ``==`` CPU; (12b) internvl2-1b at its published width
     through ``launch.train.train`` (bf16 params, fp32 moments, random
     weights from a seeded generator): ``TRAIN_STEPS`` steps of
     ``TRAIN_BATCH`` x (256 + ``TRAIN_SEQ``) positions in two
     microbatches, checkpoints every ``TRAIN_CKPT_EVERY`` steps under
     ``build/``; the step-3 checkpoints moved to another directory resume
     the same call at step 4, and, under deterministic algorithms, its
     losses, grad norms and final parameters equal the uninterrupted
     run's bit for bit; every loss finite; a flipped byte in a saved
     shard makes ``restore`` raise; printed: the step's time, positions
     and text tokens a second, save and restore seconds,
     ``max_memory_allocated``, the step's FLOP bound and AdamW's bytes
     bound, and the idle share of one profiled step (the ``train`` path
     of K3);
 13. launch and distributed (``launch/``, ``distributed/``), run after
     phase 12, once its model is released, and before the kernels line:
     (13a) ``launch.dryrun.lower_cell`` of internvl2-1b x decode_32k on
     the 2 x 16 x 16 mesh, traced on meta: per-device argument bytes
     ``==`` ``DRYRUN_ARGUMENT_BYTES``, FLOPs per device, and the cell's
     footprint on ``make_host_mesh()`` (1 x 1) against the card's memory;
     (13b) that cell whole on the card: params from a seeded generator
     placed by ``param_shardings(..., "serve")``, 24 x {k, v} x (128,
     32,768, 2, 64) bf16 caches filled with seeded normals, positions
     drawn in [0, 32,768), one ``make_serve_step`` step under the host
     mesh (its 96 ``hint_kv`` calls recorded); rows ``DIST_ROWS`` against
     a CPU run of the same rows from the caches as they were, logits and
     the written k/v slots within ``DECODE_REL`` of each row's
     max|value|, and every row's position off by one must read more; the
     step's time against its bytes bound (the cache slots up to each
     row's position), ``max_memory_allocated`` (at
     least the dry run's argument bytes) and one profiled step; (13c)
     ``gpipe`` of the arch's 24 blocks in float32 over ``DIST_STAGES``
     stages against the sequential loop, output and the grads of
     sum(h**2) within ``PIPE_TOL``; (13d) over a one-rank NCCL group,
     ``async_allreduce_scan`` of smoke yi-6b's gradients over 4
     microbatches ``==`` plain accumulation and ``pod_psum_compressed``
     (``x`` itself without a pod axis, ``== compressed_psum`` with pod =
     1).  Phase 13 launches none of K1-K6;
 14. the examples (``examples_torch/``), run after phase 13 and before
     the kernels line: every file in-process on the card at its
     reference example's sizes (``train_lm.py`` at ``TRAIN_LM_STEPS``
     steps instead of 300, from ``build/examples``), then its twin run
     (a repeat in which every launch of K1, K2, K3, K5 and K6 is held
     against the plain version on host copies of its inputs; not for
     the two examples that launch none of them), then again with
     ``--device cpu`` (all but ``train_lm.py``): each example launches the
     kernels ``EXAMPLE_KERNELS`` names, its twin run as many of each; its
     returned results and modeled fields ``==`` the CPU run's, the fault example's flip-drawn
     fields within a Poisson bound of the CPU's (flips injected), the
     LM examples' logits and greedy tokens under the LM rules (float32
     within ``LM_TOL``, bf16 within ``LM_BF16_REL`` of each row's
     max|logit|, tokens under the margin rule) and ``train_lm.py``'s
     losses finite; the telemetry example's two exports go to
     ``build/examples`` and pass ``scripts/check_trace.py``; each
     example's card, twin-run and CPU walls on one line with the card's name and
     power limit (the ``examples`` path of K1, K2, K3, K5 and K6);
 15. the ladder split across devices (``distributed/pum.py``), run after
     phase 14 and before the kernels line: each mesh over the visible
     cards where there are enough, else over ``cuda:0`` repeated (each
     position on its own stream; printed).  The chip at full ``DDR4``
     width over ``data`` = 4 and 16 (phase 7's mix queue at 8 bits and
     its chain queue), phase 7's 8-chip channel over ``("channel",
     "data")`` = (2, 4) (a mix queue of one 8-bit instruction a unit),
     the rank at the reference's subprocess geometry (2 x 2 x 2 x 2
     subarrays) over (2, 2, 2), and the faulty chip and 2-chip channel
     split as the chip (4) and the channel, an 8-bit mix queue of one
     instruction a unit, stuck-only and with phase 7's flips at a quarter
     of its lanes (``SPLIT_FAULT_MODELS``): results and every modeled
     field ``==`` the unsplit executor's on the card (the rank's also
     ``==`` the CPU's), fault runs' flip counts of every attempt and
     ``FaultStats`` too; K5 launches = rounds x positions, K6 launches
     = attempts x positions; a twin of each split run holds every slab
     launch against the plain version on host copies of its inputs,
     stacked by shape; a repeated split chip dispatch misses the table
     cache no more than the unsplit repeat.  Split and unsplit walls
     are printed beside the card (the ``split`` and ``split faults``
     paths of K5 and K6);
 16. the LM side over a device mesh (``distributed/sharding.py``,
     ``models/moe.py``, ``distributed/pipeline.py``), run after phase 15
     and before the kernels line, each mesh over the visible cards where
     there are enough, else over ``cuda:0`` repeated (each position on
     its own stream): (16a) granite-moe-1b-a400m at its published widths
     in bf16 (``MESH_LM_LAYERS`` of its 24 layers), a ``Server`` of 4
     slots serving 4 requests greedily with ``moe_impl="ep"`` under a
     (1, 4) ``("data", "model")`` mesh through ``PumServeOffload``, and
     in lockstep the grouped decode (no mesh) of the same tokens: every
     step's logits within ``MOE_EP_REL`` of each row's max|logit|,
     greedy tokens under the margin rule, rank 3's partial dropped
     before the psum must read more; one K5 launch a chip round, each
     held against the plain replay; (16b) the elastic drill of
     ``tests/test_elastic.py`` (smoke yi-6b in float32, deterministic
     algorithms): 4 ``sharded_step`` steps on (4, 2), checkpoints,
     ``recovery_plan(4, 2, 8)``, ``reshard_restore`` onto (2, 2), 4 more:
     the 8 losses ``==`` the unsharded run's, every shard ``==`` its
     slice of the gathered leaf on its position's device; (16c)
     ``gpipe`` over 4 positions of ``pod`` (``GPIPE_LAYERS`` of
     internvl2-1b's blocks at full width, float32), each stage on its
     position's stream, output and the grads of sum(h**2) within
     ``PIPE_TOL`` of the sequential blocks (the ``mesh lm`` path of K5);
 11. one JSON line with every kernel's launches on its path, its
     agreement with its plain version (per path: the launches, the
     calls compared at the path's shapes and their largest error;
     ``max_abs_err`` is the largest over the paths, and every path with
     a launch must have a comparison), its time (CUDA events), its
     kernel-only time (profiler), the plain version's time, its bound on
     the card and, where one PyTorch call computes the same function,
     that call's time; K5 and K6 add each wave's device and kernel time,
     the longest unit's real command count and ns per real command, and
     the ladder's and the server's rounds; and the kernels ranked by
     launches x (kernel time - bound) per call.

The launch counters are set to 0 just before each path (phases 3, 4, 5
and 6, each tier of phase 7, each app run of phase 8, each served run
of phase 9, the PuM forward and the counted burst of phase 10, the PuM
train steps of phase 12, each example's card run of phase 14, each
split run of phase 15 and the served ep run of phase 16) and read just
after; comparison launches come
after the read (phases 14's and 15's in their twin runs).
Any mismatch, a missing card, a failed build or a kernel with no launch
exits non-zero without the result line; each failed check names its
phase and the values it compared.  No check reads a time, a rate, an
idle share or a profiler record count: those are printed only.  Where
two float paths are compared, greedy tokens are held equal only where
the reference side's top-1/top-2 logit margin exceeds twice the stated
tolerance.  The last line is the device JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
EXPERIMENTS = ROOT / "experiments"

# H100 SXM peaks used for the bounds: HBM3 at
# 3.35 TB/s; 32-bit bitwise LOP3 (and 32-bit integer add, multiply and
# compare) at 64 per clock per SM (compute capability 9.0) x 132 SMs x
# 1.98 GHz boost = 16.7 T/s; population count at 16 per clock per SM =
# 4.18 T/s
HBM_BYTES_PER_S = 3.35e12
LOP3_PER_S = 64 * 132 * 1.98e9
# int8 tensor cores, dense: 1,979 T operations/s (data sheet), half as many
# multiply-accumulates.  K4's bound takes the larger of this and the
# binary MAC rates experiments/popmma_probe.py measures in this run (the
# b1 forms have no data-sheet rate); an int8 MAC on {0, 1} bits is one
# binary MAC
INT8_MACS_PER_S = 1979e12 / 2
PROBE_LIBRARIES = ("units", "wgmma_b1", "wgmma_s8")
# K6's integer operations, counted from csrc/replay.cu: per word and AP
# command 8 Philox calls of 10 rounds (2 multiply-high, 2 multiply-low,
# two 3-input XORs of one LOP3 each) and 2 operations per uniform
# (compare, OR), then the XOR, popcount and count addition of the mask;
# the key schedule's 9 bumps of 2 additions once per word column
PHILOX_CALL_OPS = 10 * (4 + 2) + 4 * 2
FLIP_OPS_PER_AP_WORD = 8 * PHILOX_CALL_OPS + 3
KEY_SCHEDULE_OPS = 9 * 2
# im2col shapes (M = output pixels, K = 3 x 3 x input channels, N =
# output channels) of three VGG-16 layers at the published 224 x 224
# input (src/repro/apps/vgg.py's plan)
VGG16_SHAPES = (("conv1_2", 224 * 224, 9 * 64, 64),
                ("conv3_2", 56 * 56, 9 * 256, 256),
                ("conv4_2", 28 * 28, 9 * 512, 512))
FAULT_LANES = 32768
STUCK_LANES = 16384          # three replicas fill 49,152 of 65,536 columns
# the ladder's tiers at full width: (backend, chips a channel, channels);
# two mix instructions a unit
LADDER = (("chip", 1, 1), ("channel", 8, 1), ("rank", 8, 2))
LADDER_FAULT = (("chip", 1), ("channel", 2))
# the ladder's stuck-only run: at the bank run's 0.02 every unit holds
# lanes with two replicas on stuck columns and is retired (phase 6); at
# 1e-4 a unit holds about one cluster of 4 stuck columns, so the vote
# outvotes each stuck replica and the run must be exact
LADDER_STUCK_RATE = 1e-4
# The fault layer's vote accepts a wrong value when the replicas of a
# lane were corrupted alike, in the reference as in the port, so the
# sigma = 0.15 run is not exact at this scale.  experiments/fault_share.py
# counted the wrong lanes of 1,048,576 at fault seeds 0-9: 6 to 24 (166
# in all) in the port on an H100, 9 to 19 (140 in all) in the reference
# on the CPU (PERF.md).  The bound is about twice the largest count.
WRONG_LANE_SHARE = 5e-5
# the sigma = 0.15 run at fault seed 0 as it came out before the replay
# kernels were redesigned (PERF.md): the redesign keeps every random bit
# and the vote, so the outcome must not move
SIGMA_SEED0 = {"wrong_lanes": 24, "faulty_replay_launches": 9}

# the apps (phase 8): benchmarks/paper_tables.py's app tables on their
# configurations (its "smoke" sizes, which BENCH_apps.json records, and
# its "full" sizes), rebuilt in app_runs; the port's five rungs
APPS_SMOKE_CFG = {"n_banks": 4, "subarrays_per_bank": 2, "n_chips": 2}
APPS_FULL_CFG = {"n_banks": 16, "subarrays_per_bank": 2, "n_chips": 4}
APP_RUNGS = ("bitplane", "cuda", "bank", "chip", "channel")
FUSED_RUNGS = ("bank", "chip", "channel")
# the float fields of BENCH_apps.json were summed in another order than a
# live run sums them and differ in the last bits; its integer fields
# must be equal
BENCH_REL_TOL = 1e-12
MEASURED_STATS = ("wall_s", "pack_wall_s")
# TPC-H lineitem rows at scale factor 1 (TPC-H specification, clause 4.2.5)
TPCH_SF1_ROWS = 6_001_215
# the server (phase 9): benchmarks/serving_soak.py's traffic (OPS_POOL,
# TENANTS, GENEROUS_S, TIGHT_S, a queue of three quarters of a window,
# so every window overflows) at full width: requests of one subarray's
# 65,536 columns, windows of 16 over phase 7's 8-chip channel
SERVE_OPS = ("addition", "subtraction", "multiplication", "min", "max",
             "relu", "bitcount", "division")
SERVE_TENANTS = ("alice", "bob", "carol")
SERVE_GENEROUS_S = 10.0
SERVE_TIGHT_S = 1e-7
SERVE_WINDOW = 16
SERVE_DEPTH = 3 * SERVE_WINDOW // 4
SERVE_WINDOWS = 4
SERVE_CHIPS = 8
# the faulty window's requests: the fault layer's stuck-column pattern
# spans one physical row of 65,536 columns, and a wider state raises
# (in the reference too, ROADMAP.md Queue 3), so even all 12 admitted
# requests coalesced into one instruction and replicated twice must fit
SERVE_FAULT_LANES = 2048
# a traced launch's event pair holds its kernel plus the card's own
# latency from the start event to the kernel and from the kernel to the
# end event (4-6 µs measured beside 0.06 ms rounds), which the
# profiler's kernel time leaves out
DEVICE_S_SLACK_MS = 0.010
# profiled sessions of the traced dispatch tried until the profiler has
# recorded the K5 launch of every round
TRACED_PROFILER_ATTEMPTS = 5

# the LM (phase 10).  10a: every arch at smoke_config in float32, card
# against the port's own CPU run of the same weights (cuBLAS against CPU
# BLAS, no TF32), logits and caches within LM_TOL (rtol and atol), int8
# cache entries within 1.  10b: yi-6b at its published width in bf16,
# LM_LAYERS of its 32 layers (the smoke's one cut of depth, to keep it
# near 600 s with phase 14's twin runs), on LM_SLOTS slots of LM_MAX_LEN
# positions, serving LM_PROMPTS (lengths;
# tokens from default_rng(0)) with LM_MAX_NEW new tokens each, through
# PumServeOffload on the reference's default offload chip (4 banks x 2
# subarrays).  10c: make_prefill on one prompt of LM_PREFILL_LEN tokens
# against the decode logits of the same positions, each position within
# LM_BF16_REL of its max|logit|: bf16 through all 32 layers in two orders
# of summation read 1.3-2.7e-2 at every position on an H100 (position 0
# included; 2.717e-2 at most, the same in five calls); the decode of the
# first LM_FAULT_LEN positions with one cache write dropped (at
# LM_FAULT_AT) or every step a position late must read more (0.160 and
# 1.01 on an H100 at 32 layers, 0.177 and 1.04 at 16).  Greedy tokens of two float paths are
# compared only where the reference side's top-1/top-2 margin exceeds
# twice the stated tolerance (random inits give near-ties)
LM_TOL = 1e-3
LM_ARCH = "yi-6b"
LM_LAYERS = 8
LM_SLOTS = 4
LM_MAX_LEN = 4096
LM_PROMPTS = (3, 7, 5, 2, 9, 4)
LM_MAX_NEW = 8
LM_BF16_REL = 4e-2
LM_PREFILL_LEN = 2048
LM_FAULT_LEN = 256
LM_FAULT_AT = 64
# dense bf16 tensor-core peak of one H100 SXM (data sheet, no sparsity)
BF16_FLOPS_PER_S = 989e12
# the trainer (phase 12).  12a: every arch at smoke_config in float32,
# TRAIN_SMOKE_STEPS train steps on the card against the port's own CPU run
# of the same weights and synth_batch(TRAIN_SMOKE_DATA) batches, loss,
# aux, grad norm and every parameter within LM_TOL.  The optimizer's eps
# is 1e-3 (TRAIN_SMOKE_OPT): at the default 1e-8 AdamW moves a parameter
# by about lr whatever its gradient's size, so a gradient entry within
# rounding of zero (its sign set by summation order) moves by +-lr on
# either side; with eps 1e-3 the step is a smooth function of the
# gradient.  12b: internvl2-1b at its published width in bf16 (fp32
# moments) through launch.train.train: TRAIN_STEPS steps of TRAIN_BATCH x
# (256 vision + TRAIN_SEQ text) positions in TRAIN_MICRO microbatches,
# checkpoints every TRAIN_CKPT_EVERY steps under build/, resumed from the
# first checkpoint in another directory bit for bit
TRAIN_SMOKE_STEPS = 2
TRAIN_SMOKE_DATA = (16, 4, 0)          # seq_len, global_batch, seed
TRAIN_SMOKE_OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
TRAIN_ARCH = "internvl2-1b"
TRAIN_STEPS = 6
TRAIN_SEQ = 512
TRAIN_BATCH = 8
TRAIN_MICRO = 2
TRAIN_CKPT_EVERY = 3

# launch and distributed (phase 13).  13a: the reference's dry-run cell,
# DIST_ARCH x DIST_SHAPE on the 2 x 16 x 16 mesh, traced on meta; its
# per-device argument bytes are DRYRUN_ARGUMENT_BYTES (the sum over the
# reference's specs, which tests/test_torch_dryrun.py holds on the CPU).
# 13b: the same cell whole on the card (batch 128 against a 32,768-slot
# bf16 cache, every layer), one make_serve_step step; rows DIST_ROWS
# against a CPU run of the same rows, logits and written k/v slots within
# DECODE_REL of each row's max|value|, and a planted fault (each row's
# position off by one) must read more.  13c: gpipe over DIST_STAGES
# stages of the arch's 24 blocks in float32 (no TF32), PIPE_BATCH x
# PIPE_SEQ positions in PIPE_MICRO microbatches, forward and the grads of
# sum(h**2) within PIPE_TOL of the sequential block loop: err <= PIPE_TOL
# (|want| + max|want|) elementwise, max|want| over the tensor.  13d:
# async_allreduce_scan and pod_psum_compressed over a one-rank NCCL group.
# DECODE_REL lies between what bf16 through 24 random layers reads and
# what the fault reads: over 6 seeds x 8 rows on an H100
# (experiments/decode32k_tolerance.py) the card's rows sit at most
# 4.82e-2 of max|value| from the CPU's bf16 run (5.11e-2 from a float32
# one), and a position off by one reads 0.402 or more
DIST_ARCH = "internvl2-1b"
DIST_SHAPE = "decode_32k"
DRYRUN_ARGUMENT_BYTES = 119_685_856
DIST_ROWS = (0, 1, 127)
DIST_SEED = 13
DECODE_REL = 1e-1
DIST_STAGES = 4
PIPE_MICRO = 4
PIPE_BATCH = 8
PIPE_SEQ = 512
PIPE_TOL = 1e-3

# the ladder split across devices (phase 15): the chip over "data" =
# SPLIT_CHIP_POSITIONS, phase 7's 8-chip channel over ("channel", "data")
# = SPLIT_CHANNEL_MESH, the reference's subprocess rank geometry
# (tests/test_rank.py) over SPLIT_RANK_MESH, and the fault wrappers (the
# chip, a channel of SPLIT_FAULT_CHIPS chips) split as the chip's first
# mesh and the channel's, stuck-only and with phase 7's flips.  The flips
# run at a quarter of phase 7's lanes: at 32,768 the phase took 38.3 s,
# 18.3 s of it the plain versions of its twins (PERF.md), against a 30 s
# budget
SPLIT_CHIP_POSITIONS = (4, 16)
SPLIT_CHANNEL_CHIPS = 8
SPLIT_CHANNEL_MESH = (2, 4)
SPLIT_RANK = {"n_channels": 2, "n_chips": 2, "n_banks": 2,
              "n_subarrays": 2}
SPLIT_RANK_MESH = (2, 2, 2)
SPLIT_FAULT_CHIPS = 2
SPLIT_FAULT_MODELS = (
    ("flips", FAULT_LANES // 4, dict(sigma=0.15, spare_lanes=1, seed=0,
                                     max_retries=10)),
    ("stuck", STUCK_LANES, dict(p_flip=0.0, stuck_lane_rate=1e-4,
                                spare_lanes=2, seed=0)))

# phase 16: the LM side over a device mesh (positions of cuda:0 repeated
# on one card).  16a serves granite-moe-1b-a400m at its published widths
# (MESH_LM_LAYERS of its 24 layers) with moe_impl="ep" over MESH_LM_MESH
# through PumServeOffload, the grouped decode of the same tokens beside
# it; its logits within MOE_EP_REL of each row's max|logit|, set between
# experiments/moe_ep_tolerance.py's readings on the H100 over 6 seeds
# under deterministic algorithms: sound at most 7.855e-2, a model rank's
# partial dropped at least 0.2089.
MESH_LM_ARCH = "granite-moe-1b-a400m"
MESH_LM_LAYERS = 24
MESH_LM_MESH = (1, 4)
MESH_LM_PROMPTS = (3, 5, 2, 4)
MESH_LM_MAX_NEW = 4
MESH_LM_MAX_LEN = 64
MESH_LM_SEED = 17
MOE_EP_REL = 0.12
MESH_LM_DROP_RANK = 3
# 16b: the elastic drill of tests/test_elastic.py, smoke yi-6b in float32
DRILL_MESHES = ((4, 2), (2, 2))
DRILL_DATA = (32, 8, 0)          # seq_len, global_batch, seed
DRILL_OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=40)
# 16c: gpipe over DIST_STAGES positions of pod, GPIPE_LAYERS of
# internvl2-1b's blocks at full width in float32
GPIPE_LAYERS = 8
TRANSPOSE_WIDTHS = (8, 16, 32)
# the examples (phase 14): every examples_torch/ file at its reference's
# sizes, with the kernels its path must launch on the card (K1 h2v, K2
# v2h, K3 circuit, K5 replay, K6 faulty_replay); train_lm.py runs
# TRAIN_LM_STEPS steps instead of its default 300
EXAMPLE_KERNELS = {
    "quickstart": ("h2v", "v2h", "circuit", "replay"),
    "bank_scaling_quickstart": ("replay",),
    "fused_dispatch_quickstart": ("h2v", "v2h", "replay"),
    "compaction_quickstart": ("v2h", "replay"),
    "simdram_database": ("circuit",),
    "chip_offload_quickstart": ("v2h", "replay"),
    "channel_quickstart": ("v2h", "replay"),
    "rank_overlap_quickstart": ("v2h", "replay"),
    "fault_tolerance_quickstart": ("replay", "faulty_replay"),
    "telemetry_quickstart": ("replay", "faulty_replay"),
    "serving_quickstart": ("replay", "faulty_replay"),
    "pum_offload_demo": ("circuit",),
    "serve_llm": (),
    "train_lm": (),
}
EXAMPLE_KERNELS_ALL = ("h2v", "v2h", "circuit", "replay", "faulty_replay")
TRAIN_LM_STEPS = 4
MIX_OPS = ("addition", "multiplication", "greater", "and_red")
FAST_PATH = [(op, 8) for op in (
    "abs", "addition", "and_red", "bitcount", "division", "equal", "greater",
    "greater_equal", "if_else", "max", "min", "multiplication", "or_red",
    "relu", "subtraction", "xor_red")] + [
    ("addition", 16), ("multiplication", 16), ("greater", 16)]


class SmokeFailure(RuntimeError):
    pass


# profiler sessions tried before a time is taken another way, and the
# kernels that kernel_ms timed with CUDA events because no session
# recorded them
PROFILER_ATTEMPTS = 3
PROFILER_MISSES: list = []


# the phase that is running, named in every failed check's message
PHASE = ["0"]
# wall seconds spent in each numbered phase, its lettered parts included
PHASE_WALL: dict = {}
_PHASE_SINCE: list = [None, 0.0]


def phase(label: str) -> None:
    PHASE[0] = label
    top = label.rstrip("abcdefghijklmnopqrstuvwxyz")
    if top != _PHASE_SINCE[0]:
        stop_phase_clock()
        _PHASE_SINCE[:] = [top, time.perf_counter()]


def stop_phase_clock() -> None:
    top, since = _PHASE_SINCE
    if top is not None:
        PHASE_WALL[top] = PHASE_WALL.get(top, 0.0) + (
            time.perf_counter() - since)
        _PHASE_SINCE[0] = None


def check(cond: bool, what: str) -> None:
    """Fail the smoke with ``what``, prefixed by the running phase.  No
    check reads a time, a rate or a profiler record count: those are
    printed only."""
    if not cond:
        raise SmokeFailure(f"[phase {PHASE[0]}] {what}")


def note_profiled(where: str, kernel: str, b: dict) -> None:
    """Say where a profiled session recorded no ``kernel`` (the profiler
    drops one now and then): its busy time and idle share then miss the
    kernel.  Printed, never checked."""
    if not any(kernel in k for k in b["device_ms"]):
        print(f"[{where}] the profiler recorded no {kernel} launch in this "
              f"session: its card busy time and idle share leave it out",
              flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def bound(n_bytes: float, n_ops: float, ops_per_s: float = LOP3_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM and operations
    over their rate (32-bit integer and bitwise by default)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    import torch
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host ms per call of ``fn`` (a bare launch) over ``reps`` calls: the
    time to enqueue, on the host's clock, with the card kept busy."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without namespace, return type,
    template arguments or parameters."""
    name = key.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip().split(" ")[-1]


def kernel_ms(fn, reps: int, name: str) -> float:
    """Kernel-only ms per launch: ``torch.profiler``'s self device time of
    the kernel ``name`` over ``reps`` calls of ``fn`` (after one warm-up
    call), divided by the kernel's launches in them.  A session that
    records none of the launches (the profiler drops one now and then,
    and now and then every session for a while) is repeated, up to
    PROFILER_ATTEMPTS sessions in all; after that the kernel is timed with
    CUDA events over ``reps`` calls instead (the host's launch rate
    where that is longer), and the miss is kept in PROFILER_MISSES."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and kernel_name(e.key) == name):
                us += e.self_device_time_total
                n += e.count
        if n > 0:
            return us / n / 1e3
    seen = sorted({kernel_name(e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})
    ms = time_ms(fn, reps)
    PROFILER_MISSES.append({"kernel": name, "device_events_seen": seen,
                            "events_ms": ms})
    print(f"[profiler] no {name} launch in {PROFILER_ATTEMPTS} sessions "
          f"(device events {seen}); timed by CUDA events instead: "
          f"{ms:.4f} ms", flush=True)
    return ms


def device_breakdown(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall, device time by
    kernel or copy name and the device's idle share of the wall (one
    stream, so busy spans do not overlap).  Only device-side events
    count: a host op's device time is that of its kernels and copies,
    which are counted themselves, and the profiler's own buffer requests
    are not the program's work.  A session that records no device event
    runs ``fn`` again, up to PROFILER_ATTEMPTS sessions in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILER_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ms = {}
        for e in prof.key_averages():
            us = e.self_device_time_total
            if (e.device_type != DeviceType.CUDA or us <= 0
                    or e.key == "Activity Buffer Request"):
                continue
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].strip() or e.key
            device_ms[name] = device_ms.get(name, 0.0) + us / 1e3
        if device_ms:
            break
    busy = sum(device_ms.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms": dict(sorted(device_ms.items(),
                                     key=lambda kv: -kv[1]))}


def replay_ops_per_word(t: np.ndarray, counts: np.ndarray,
                        fault_thr=None) -> int:
    """Bitwise operations a word column needs for the (n_units, n_cmds,
    13) tables ``t`` replayed to each unit's real command count
    ``counts``: one LOP3 per majority and per complemented port.  With
    ``fault_thr`` (K6) add the stuck masking of the three writes of every
    real command and, when the threshold needs random bits, the flip mask
    of each AP.  (The NOPs after a unit's count are all zeros: no AP, no
    complement.)"""
    is_ap = t[..., 0] == 1
    ops = int(is_ap.sum()
              + np.where(is_ap, t[..., 2] + t[..., 4] + t[..., 6]
                         + t[..., 8] + t[..., 10] + t[..., 12],
                         t[..., 2] + t[..., 8]).sum())
    if fault_thr is not None:
        ops += 3 * int(counts.sum())
        if 0 < fault_thr < 1 << 32:
            ops += (FLIP_OPS_PER_AP_WORD * int(is_ap.sum())
                    + KEY_SCHEDULE_OPS * t.shape[0])
    return ops


def add_replay_wave(k: dict, wave_ms: float, tables, schedule) -> None:
    """Add one wave's device time, longest real command count and real
    table bytes to a K5 or K6 entry."""
    counts = schedule[0].cpu().numpy()
    longest = int(counts.max())
    k["wave_device_ms"].append(wave_ms)
    k["longest_unit_cmds"].append(longest)
    k["ns_per_real_cmd"].append(wave_ms * 1e6 / max(longest, 1))
    k["bytes"] += int(counts.sum()) * 13 * 4


def mix_queue(bank_mod, get_op, lanes, n_instrs=32, widths=(8, 16), seed=0):
    """benchmarks/bank_scaling.py:_mix_queue, rebuilt on the port."""
    rng = np.random.default_rng(seed)
    queue = []
    for i in range(n_instrs):
        op = MIX_OPS[i % len(MIX_OPS)]
        w = widths[(i // len(MIX_OPS)) % len(widths)]
        ops = tuple(rng.integers(0, 1 << b, lanes).astype(np.uint64)
                    for b in get_op(op, w).operand_bits)
        queue.append(bank_mod.BbopInstr(op, ops, w))
    return queue


def chain_queue(bank_mod, lanes, device, seed=1):
    """benchmarks/bank_scaling.py:_chain_queue (mul8 -> add16 -> relu16,
    relu kept vertical), rebuilt on the port; the first chain's add16
    operand enters through the transposition unit (K1)."""
    rng = np.random.default_rng(seed)
    queue, raw = [], []
    for c in range(4):
        x, y = (rng.integers(0, 256, lanes).astype(np.uint64)
                for _ in range(2))
        z = rng.integers(0, 1 << 16, lanes).astype(np.uint64)
        raw.append((x, y, z))
        z_op = (bank_mod.VerticalOperand.from_values(z, 16, device=device)
                if c == 0 else z)
        base = len(queue)
        queue.append(bank_mod.BbopInstr("multiplication", (x, y), 8))
        queue.append(bank_mod.BbopInstr("addition", (bank_mod.Ref(base), z_op),
                                        16))
        queue.append(bank_mod.BbopInstr("relu", (bank_mod.Ref(base + 1),), 16,
                                        keep_vertical=True))
    return queue, raw


def fmt_list(xs) -> str:
    return "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"


def masked_equal(got, want, out_bits) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    return all(
        np.array_equal(np.asarray(g).astype(np.int64) & ((1 << w) - 1),
                       np.asarray(e).astype(np.int64) & ((1 << w) - 1))
        for g, e, w in zip(got, want, out_bits))


def run(trace_path: str) -> dict:
    import torch

    from repro_torch.core import bitplane
    from repro_torch.core.bank import Bank, plan_queue, flatten_result
    from repro_torch.core import bank as bank_mod
    from repro_torch.core.control_unit import (CMD_WIDTH, replay,
                                               replay_plain)
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.ops_library import get_op
    from repro_torch.core.timing import DDR4
    from repro_torch.kernels import build
    from repro_torch.kernels.bitplane_ops import _launch as k3_launch
    from repro_torch.kernels.bitplane_ops import (circuit_on_planes,
                                                  circuit_plain, slot_program)
    from repro_torch.kernels.ops import h2v
    from repro_torch.kernels.ref import elementwise_circuit_ref
    from repro_torch.kernels.transpose_kernel import (h2v_cuda, h2v_plain,
                                                      v2h_cuda, v2h_plain)
    import popmma_probe

    dev = torch.device("cuda")
    record: dict = {"card": nvidia_smi("name,power.limit"),
                    "trace_path": trace_path}

    # -- 1. build --------------------------------------------------------
    phase("1")
    # the unit-rate probes of K4's bound (phase 5) build beside the kernels
    t0 = time.perf_counter()
    probes = popmma_probe.start_builds(build, PROBE_LIBRARIES)
    build_s = build.build_all()
    probe_libs = popmma_probe.finish_builds(probes)
    record["build_s"] = time.perf_counter() - t0
    print(f"[1] built {len(build.LIBRARIES)} kernel libraries in "
          f"{build_s:.1f} s (nvcc runs: {sum(build.BUILDS.values())}) and "
          f"{len(PROBE_LIBRARIES)} unit-rate probes, "
          f"{record['build_s']:.1f} s in all")
    for line in build.build_log().splitlines():
        if line.startswith("==") or any(k in line for k in (
                "Compiling entry", "registers", "spill")):
            print("[1]   " + line.strip())
    for name, lib in probe_libs.items():
        log = lib if isinstance(lib, str) else lib.build_log
        refused = " (refused by nvcc)" if isinstance(lib, str) else ""
        for line in log.splitlines():
            if isinstance(lib, str) or "arning" in line:
                print(f"[1]   probe {name}{refused}: {line.strip()}")

    # -- 2. K1/K2 at 1,048,576 lanes --------------------------------------
    phase("2")
    n_lanes = DDR4.simd_lanes
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.integers(0, 2**32, n_lanes, dtype=np.uint32)
                            .view(np.int32)).to(dev)
    planes = h2v_cuda(vals)
    err_h2v = max_abs_err(planes, h2v_plain(vals))
    back = v2h_cuda(planes)
    err_v2h = max_abs_err(back, v2h_plain(planes))
    torch.cuda.synchronize()
    check(err_h2v == 0 and err_v2h == 0, "K1/K2 disagree with plain")
    check(torch.equal(back, vals), "h2v -> v2h round trip is not exact")
    n_words = n_lanes // 32
    # each kernel at 8, 16 and 32 planes: the wrapper, the bare launch
    # (CUDA events over a loop of launches, and the host's enqueue time),
    # and the kernel alone (the profiler); bytes: each lane value once and
    # each plane word once
    kern = {"h2v": {"per_width": {}}, "v2h": {"per_width": {}}}
    errs_t = {"h2v": [err_h2v], "v2h": [err_v2h]}
    for k in TRANSPOSE_WIDTHS:
        pk = h2v_cuda(vals, k)
        vk = v2h_cuda(pk)
        err_h = max_abs_err(pk, h2v_plain(vals, k))
        err_v = max(max_abs_err(vk, v2h_plain(pk)),
                    max_abs_err(v2h_cuda(pk, signed=True),
                                v2h_plain(pk, signed=True)))
        torch.cuda.synchronize()
        check(err_h == 0 and err_v == 0,
              f"K1/K2 at {k} planes disagree with plain (K2 signed and "
              f"unsigned)")
        errs_t["h2v"].append(err_h)
        errs_t["v2h"].append(err_v)
        h2v_bare = (lambda: build.launch(
            "transpose", "h2v_launch", vals.data_ptr(), pk.data_ptr(),
            n_words, k))
        v2h_bare = (lambda: build.launch(
            "transpose", "v2h_launch", pk.data_ptr(), vk.data_ptr(),
            n_words, k, 0))
        for name, wrapper, bare in (
                ("h2v", lambda: h2v_cuda(vals, k), h2v_bare),
                ("v2h", lambda: v2h_cuda(pk), v2h_bare)):
            row = {"ms": time_ms(wrapper, 50),
                   "device_ms": time_ms(bare, 50),
                   "kernel_ms": kernel_ms(bare, 50, f"{name}_kernel"),
                   "launch_host_ms": host_ms(bare, 50),
                   "bound_ms": bound((4 + k / 8) * n_lanes, 0)[0]}
            kern[name]["per_width"][k] = row
            print(f"[2] {name} at {k} planes: kernel {row['kernel_ms']:.4f} "
                  f"ms (profiler), bare launch {row['device_ms']:.4f} ms "
                  f"(events; host {row['launch_host_ms']:.4f} ms a call), "
                  f"wrapper {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms")
    for name, plain, arg in (("h2v", h2v_plain, vals),
                             ("v2h", v2h_plain, planes)):
        k = kern[name]
        k.update({key: k["per_width"][32][key] for key in (
            "ms", "device_ms", "kernel_ms", "launch_host_ms")})
        k["max_abs_err"] = err_h2v if name == "h2v" else err_v2h
        k["plain_ms"] = time_ms(lambda: plain(arg), 5)
        k["bound"] = bound(2 * 4 * n_lanes, 0)
        k["shape"] = f"{n_lanes} lanes x 32 planes"
        k["n_calls"] = 1
    print(f"[2] K1/K2 round trip on {n_lanes} lanes: bit-exact at "
          f"{TRANSPOSE_WIDTHS} planes, K2 signed and unsigned; at 32: h2v "
          f"{kern['h2v']['ms']:.4f} ms, v2h {kern['v2h']['ms']:.4f} ms")

    # -- 3. the fast path: bbop on backend="cuda" (main path) -------------
    phase("3")
    inputs = {}
    for op, w in FAST_PATH:
        spec = get_op(op, w)
        r = np.random.default_rng(len(op) * 100 + w)
        inputs[(op, w)] = [r.integers(0, 1 << b, n_lanes).astype(np.int64)
                           for b in spec.operand_bits]
    build.reset_launches()
    fast = SimdramDevice(backend="cuda", device="cuda")
    for op, w in FAST_PATH:
        spec = get_op(op, w)
        got = fast.bbop(op, *inputs[(op, w)], n_bits=w)
        want = spec.oracle(*[v.astype(np.uint64) for v in inputs[(op, w)]])
        check(masked_equal(got, want, spec.out_bits),
              f"backend='cuda' {op}/{w} disagrees with the oracle")
    before = build.LAUNCHES["circuit"]
    bp = SimdramDevice(backend="bitplane", device="cuda")
    got = bp.bbop("addition", *inputs[("addition", 8)], n_bits=8)
    check(masked_equal(got, get_op("addition", 8).oracle(
        *[v.astype(np.uint64) for v in inputs[("addition", 8)]]), (8,)),
        "backend='bitplane' addition/8 disagrees with the oracle")
    torch.cuda.synchronize()
    counts_fast = dict(build.LAUNCHES)
    check(counts_fast["circuit"] > before,
          "backend='bitplane' did not launch the circuit kernel")
    print(f"[3] SimdramDevice(backend='cuda').bbop: {len(FAST_PATH)} ops x "
          f"{n_lanes} lanes match spec.oracle; backend='bitplane' launched "
          f"K3 {counts_fast['circuit'] - before}x; launches {counts_fast}")

    # K3 against the plain circuit on the card, and its times: the
    # wrapper, the bare launch (events) and the kernel alone (profiler)
    k3 = {"max_abs_err": 0, "ms": 0.0, "device_ms": 0.0, "kernel_ms": 0.0,
          "plain_ms": 0.0, "bytes": 0, "ops": 0, "n_calls": len(FAST_PATH)}
    per_op, errs_k3 = {}, []
    for op, w in FAST_PATH:
        spec, circ, ids = bitplane._compiled_op(op, w)
        vals_t = [torch.from_numpy(bitplane.host_i32(v)).to(dev)
                  for v in inputs[(op, w)]]
        ops_planes = [h2v(t, b) for t, b in zip(vals_t, spec.operand_bits)]
        out = circuit_on_planes(circ, ids, ops_planes)
        err = max_abs_err(out, circuit_plain(circ, ids, ops_planes))
        check(err == 0, f"K3 {op}/{w} disagrees with the plain circuit")
        errs_k3.append(err)
        # and against K3's oracle, the eager bitplane backend on the CPU
        oracle = elementwise_circuit_ref(op, w, *inputs[(op, w)])
        oracle = oracle if isinstance(oracle, tuple) else (oracle,)
        ends = np.cumsum(spec.out_bits)
        check(all(torch.equal(v2h_plain(out[hi - ow:hi].contiguous()).cpu(),
                              want_lanes)
                  for hi, ow, want_lanes in zip(ends, spec.out_bits, oracle)),
              f"K3 {op}/{w} disagrees with elementwise_circuit_ref")
        # the fast path's transposes at this op's widths: K1 on each
        # operand, K2 (unsigned and signed) on each output
        errs_t["h2v"] += [max_abs_err(pl, h2v_plain(t, b)) for pl, t, b in
                          zip(ops_planes, vals_t, spec.operand_bits)]
        check(ends[-1] == out.shape[0], f"{op}/{w}: {out.shape[0]} output "
              f"planes for widths {spec.out_bits}")
        for lo, hi in zip(ends - spec.out_bits, ends):
            sl = out[lo:hi].contiguous()
            errs_t["v2h"] += [max_abs_err(v2h_cuda(sl, signed=sg),
                                          v2h_plain(sl, signed=sg))
                              for sg in (False, True)]
        check(max(errs_t["h2v"] + errs_t["v2h"]) == 0,
              f"K1/K2 at {op}/{w}'s widths disagree with plain")
        prog = slot_program(circ, ids)
        code = torch.from_numpy(prog.code).to(dev)
        words = out.shape[1]
        bare = (lambda: k3_launch(prog, code, ops_planes, out))
        row = {
            "ms": time_ms(lambda: circuit_on_planes(circ, ids, ops_planes),
                          20),
            "device_ms": time_ms(bare, 20),
            "kernel_ms": kernel_ms(bare, 20, "circuit_kernel"),
            "launch_host_ms": host_ms(bare, 20),
            "plain_ms": time_ms(lambda: circuit_plain(circ, ids, ops_planes),
                                2, warmup=1),
            "gates": prog.n_gates, "levels": prog.n_levels,
            "steps": prog.n_steps, "slots": prog.n_slots,
            "warps": prog.warps, "chunks": len(prog.chunks) - 1,
            "shared_bytes": prog.shared_bytes,
        }
        n_bytes = 4 * words * (prog.n_inputs + prog.n_outputs)
        n_ops = prog.n_logic * words
        row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops)
        per_op[f"{op}/{w}"] = row
        print(f"[3] K3 {op}/{w}: kernel {row['kernel_ms']:.4f} ms "
              f"(profiler), bare launch {row['device_ms']:.4f} ms (host "
              f"{row['launch_host_ms']:.4f} ms a call), bound "
              f"{row['bound_ms']:.4f} ms; {prog.n_gates} gates, "
              f"{prog.n_levels} levels, {prog.n_slots} slots, "
              f"{prog.warps} warps")
        for k in ("ms", "device_ms", "kernel_ms", "plain_ms"):
            k3[k] += row[k]
        k3["bytes"] += n_bytes
        k3["ops"] += n_ops
    k3["launch_host_ms"] = float(np.mean([r["launch_host_ms"]
                                          for r in per_op.values()]))
    k3_bound_ms = sum(r["bound_ms"] for r in per_op.values())
    k3["bound"] = (k3_bound_ms, bound(k3["bytes"], k3["ops"])[1])
    k3["shape"] = (f"sum over {len(FAST_PATH)} ops (16 at 8 bits, 3 at 16 "
                   f"bits) x {n_lanes} lanes")
    kern["circuit"] = k3
    record["k3_per_op"] = per_op
    # the fast path's transposes run at phase 2's lanes and widths
    for name, errs in errs_t.items():
        kern[name]["agreement"] = {}
        _agree(kern[name]["agreement"], "fast", counts_fast[name], errs)
    k3["agreement"] = {}
    _agree(k3["agreement"], "fast", counts_fast["circuit"], errs_k3)
    print(f"[3] K3 vs plain circuit on the card and vs "
          f"elementwise_circuit_ref on the CPU: bit-exact for "
          f"{len(FAST_PATH)} ops; kernel total {k3['kernel_ms']:.4f} ms "
          f"(profiler), wrapper {k3['ms']:.3f} ms, bound "
          f"{k3_bound_ms:.4f} ms")

    # -- 4. the slice: fused bank dispatch (main path) ---------------------
    phase("4")
    lanes = DDR4.columns_per_subarray
    mix = mix_queue(bank_mod, get_op, lanes)
    build.reset_launches()
    bank_dev = SimdramDevice(backend="bank", device="cuda")
    t0 = time.perf_counter()
    chain, chain_raw = chain_queue(bank_mod, lanes, "cuda")
    res_mix = bank_dev.dispatch(mix)
    res_chain = bank_dev.dispatch(chain)
    chain_vals = [flatten_result(r) for r in res_chain]   # relu via K2
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_bank = dict(build.LAUNCHES)
    for name, errs in _chain_transposes(dev, chain, chain_raw, res_chain,
                                        [v[0] for v in chain_vals]).items():
        _agree(kern[name]["agreement"], "bank", counts_bank[name], errs)
    for i, ins in enumerate(mix):
        spec = get_op(ins.op, ins.n_bits)
        check(masked_equal(res_mix[i], spec.oracle(*ins.operands),
                           spec.out_bits),
              f"mix instruction {i} ({ins.op}/{ins.n_bits}) is wrong")
    mul, add, relu = (get_op(op, w) for op, w in (
        ("multiplication", 8), ("addition", 16), ("relu", 16)))
    for c, (x, y, z) in enumerate(chain_raw):
        m = mul.oracle(x, y)[0]          # the full 16-bit product
        a = add.oracle(m, z)[0]
        r = relu.oracle(a)[0]
        check(all(masked_equal(chain_vals[3 * c + k][0], (e,), spec.out_bits)
                  for k, (e, spec) in enumerate(((m, mul), (a, add),
                                                 (r, relu)))),
              f"chain {c} is wrong")
    stats = bank_dev.bank().stats.as_dict()
    record["bank_stats"] = stats
    record["bank_wall_s"] = wall
    print(f"[4] bank dispatch: mix {len(mix)} x {lanes} lanes and chain "
          f"{len(chain)} instrs match the oracle in {wall:.3f} s host wall, "
          f"first dispatch, μProgram compile included (pack "
          f"{stats['pack_wall_s']:.3f} s); launches {counts_bank}")
    print(f"[4] BankStats {json.dumps(stats)}")

    # K5 on each of the mix queue's fused waves, against the plain replay
    bank = Bank(n_subarrays=DDR4.n_banks, device="cuda")
    q_lanes, stage, _ = plan_queue(mix)
    waves = bank._build_waves(mix, list(range(len(mix))), stage, q_lanes)
    k5 = {"max_abs_err": 0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
          "bytes": 0, "ops": 0, "wave_device_ms": [], "wave_kernel_ms": [],
          "longest_unit_cmds": [], "ns_per_real_cmd": []}
    errs_k5 = []
    for wave in waves:
        states_np, ct, _ = bank._pack_wave(mix, wave, q_lanes, {})
        tables, schedule = ct
        states = torch.from_numpy(states_np.view(np.int32)).to(dev)
        out_k = replay(states, ct)
        out_p = replay_plain(states, tables)
        err = max_abs_err(out_k, out_p)
        check(err == 0, "K5 disagrees with the plain replay")
        errs_k5.append(err)
        n_units, n_rows, w_words = states.shape
        out = torch.empty_like(states)
        n_cmds = tables.shape[1]
        k5["ms"] += time_ms(lambda: replay(states, ct), 10)
        bare = (lambda: build.launch(
            "replay", "replay_launch", states.data_ptr(), out.data_ptr(),
            tables.data_ptr(), n_cmds * CMD_WIDTH, schedule.data_ptr(),
            n_units, n_rows, w_words, n_cmds))
        wave_ms = time_ms(bare, 10)
        k5["device_ms"] += wave_ms
        k5["wave_kernel_ms"].append(kernel_ms(bare, 10, "replay_kernel"))
        k5["launch_host_ms"] = host_ms(bare, 10)
        k5["plain_ms"] += time_ms(lambda: replay_plain(states, tables), 1,
                                  warmup=0)
        k5["ops"] += replay_ops_per_word(
            tables.cpu().numpy(), schedule[0].cpu().numpy()) * w_words
        k5["bytes"] += 2 * states.numel() * 4
        add_replay_wave(k5, wave_ms, tables, schedule)
    k5["kernel_ms"] = sum(k5["wave_kernel_ms"])
    k5["n_calls"] = len(waves)
    # the chain queue's waves forward planes between waves, so they are
    # taken from a repeat of its dispatch
    with _RecordedInterpreter(bank_mod, "hetero_batched_interpreter") as rec:
        [flatten_result(r) for r in SimdramDevice(
            backend="bank", device="cuda").dispatch(chain)]
    check(len(waves) + len(rec) == counts_bank["replay"],
          f"{len(waves)} mix and {len(rec)} chain waves for "
          f"{counts_bank['replay']} K5 launches")
    errs_k5 += [_round_k5(dev, st, ct, reps=1)[2] for st, ct in rec]
    k5["agreement"] = {}
    _agree(k5["agreement"], "bank", counts_bank["replay"], errs_k5)
    k5["bound"] = bound(k5["bytes"], k5["ops"])
    k5["shape"] = (f"sum over the mix queue's {len(waves)} fused waves, "
                   f"{DDR4.n_banks} units x {lanes} columns")
    kern["replay"] = k5
    print(f"[4] K5 vs plain replay on {len(waves)} mix waves: bit-exact; "
          f"kernel total {k5['ms']:.3f} ms, per wave (device) "
          f"{fmt_list(k5['wave_device_ms'])} ms, (profiler) "
          f"{fmt_list(k5['wave_kernel_ms'])} ms at longest real counts "
          f"{k5['longest_unit_cmds']} ({fmt_list(k5['ns_per_real_cmd'])} "
          f"ns per command); bound {k5['bound'][0]:.4f} ms")

    # the same dispatches again, warm (every μProgram compiled, every
    # wave's tables cached), then once more under the profiler: where a
    # repeated bank dispatch's wall goes, host vs device
    again = SimdramDevice(backend="bank", device="cuda")
    t0 = time.perf_counter()
    again.dispatch(mix)
    [flatten_result(r) for r in again.dispatch(chain)]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    warm_pack = again.bank().stats.pack_wall_s
    record["bank_warm_wall_s"] = warm
    record["bank_warm_pack_wall_s"] = warm_pack
    print(f"[4] warm repeat of both dispatches: {warm:.3f} s host wall "
          f"(pack {warm_pack:.3f} s)")
    breakdown = {
        "mix": device_breakdown(lambda: again.dispatch(mix)),
        "chain": device_breakdown(lambda: [
            flatten_result(r) for r in again.dispatch(chain)]),
    }
    record["bank_breakdown"] = breakdown
    note_profiled("4", "replay_kernel", breakdown["mix"])
    for name, b in breakdown.items():
        print(f"[4] profiled {name} dispatch: wall {b['wall_ms']:.2f} ms, "
              f"device busy {b['device_busy_ms']:.3f} ms, idle share "
              f"{b['idle_share']:.4f}; device ms {json.dumps(b['device_ms'])}")

    phase("5")
    kern["popmatmul"], counts_mm = matmul_phase(dev, record, probe_libs)
    phase("6")
    kern["faulty_replay"], counts_fault = fault_phase(dev, record, mix_queue)
    phase("7")
    counts_ladder = ladder_phase(dev, record, kern)
    phase("8")
    counts_apps = apps_phase(dev, record, kern)
    phase("9")
    counts_serve = serving_phase(dev, record, kern)
    release_device_memory()
    phase("10")
    counts_lm = lm_phase(dev, record, kern)
    release_device_memory("12")
    phase("12")
    counts_train = train_phase(dev, record, kern)
    release_device_memory("13")
    phase("13")
    distributed_phase(dev, record)
    release_device_memory("14")
    phase("14")
    counts_examples = examples_phase(dev, record, kern)
    phase("15")
    counts_split = split_phase(dev, record, kern)
    release_device_memory("16")
    phase("16")
    counts_mesh = mesh_lm_phase(dev, record, kern)

    # -- 11. the kernels line -----------------------------------------------
    phase("11")
    for name in ("h2v", "v2h", "circuit", "replay"):
        n = counts_fast[name] + counts_bank[name]
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(counts_fast["circuit"] > 0 and counts_bank["replay"] > 0
          and counts_bank["h2v"] > 0 and counts_bank["v2h"] > 0,
          "a kernel of its path was not launched")
    check(counts_mm["popmatmul"] > 0 and counts_fault["faulty_replay"] > 0,
          "K4 or K6 was not launched on its path")
    check(counts_bank["replay"] == 5,
          f"expected 5 K5 launches on the bank path, got "
          f"{counts_bank['replay']}")
    check(all(counts_apps[name] > 0
              for name in ("h2v", "v2h", "circuit", "replay")),
          f"a kernel of the apps path was not launched: {counts_apps}")
    check(counts_serve["replay"] > 0 and counts_serve["faulty_replay"] > 0,
          f"K5 or K6 was not launched on the serving path: {counts_serve}")
    check(counts_lm["circuit"] > 0 and counts_lm["replay"] > 0,
          f"K3 or K5 was not launched on the LM path: {counts_lm}")
    check(counts_train["circuit"] > 0,
          f"K3 was not launched on the training path: {counts_train}")
    check(counts_split["replay"] > 0 and counts_split["faulty_replay"] > 0,
          f"K5 or K6 was not launched on the split path: {counts_split}")
    check(counts_mesh["replay"] > 0,
          f"K5 was not launched on the mesh LM path: {counts_mesh}")
    launches = {name: counts_fast[name] + counts_bank[name]
                + counts_ladder[name] + counts_apps[name]
                + counts_serve[name] + counts_lm[name] + counts_train[name]
                + counts_examples[name] + counts_split[name]
                + counts_mesh[name]
                for name in ("h2v", "v2h", "circuit", "replay")}
    launches["popmatmul"] = counts_mm["popmatmul"]
    launches["faulty_replay"] = (counts_fault["faulty_replay"]
                                 + counts_ladder["faulty_replay"]
                                 + counts_serve["faulty_replay"]
                                 + counts_examples["faulty_replay"]
                                 + counts_split["faulty_replay"])
    meta = {
        "h2v": ("src/repro_torch/csrc/transpose.cu",
                "src/repro/kernels/transpose_kernel.py:75"),
        "v2h": ("src/repro_torch/csrc/transpose.cu",
                "src/repro/kernels/transpose_kernel.py:105"),
        "circuit": ("src/repro_torch/csrc/circuit.cu",
                    "src/repro/kernels/bitplane_ops.py:57"),
        "replay": ("src/repro_torch/csrc/replay.cu",
                   "src/repro/core/control_unit.py:126"),
        "popmatmul": ("src/repro_torch/csrc/popmatmul.cu",
                      "src/repro/kernels/bitserial_matmul.py:75"),
        "faulty_replay": ("src/repro_torch/csrc/replay.cu",
                          "src/repro/core/control_unit.py:370"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        k = kern[name]
        # every launch of the main path had a twin at its shape compared
        # with the plain version; max_abs_err covers those comparisons
        agreement = k["agreement"]
        on_path = sum(a["launches"] for a in agreement.values())
        check(on_path == launches[name], f"{name}: {on_path} launches in "
              f"its agreement, {launches[name]} on the main path")
        check(all(a["compared"] > 0 for a in agreement.values()),
              f"{name}: a path without a comparison: {agreement}")
        k["max_abs_err"] = max(a["max_abs_err"] for a in agreement.values())
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "agreement": agreement,
            "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1], "library_ms": k.get("library_ms"),
            "device_ms": k["device_ms"], "kernel_ms": k["kernel_ms"],
            "launch_host_ms": k["launch_host_ms"],
            "rank_ms": launches[name] * (k["kernel_ms"] - k["bound"][0])
            / k["n_calls"],
            "shape": k["shape"],
            "tolerance": "bit-exact (max_abs_err 0 over int32 words)",
        })
        for key in ("wave_device_ms", "wave_kernel_ms", "longest_unit_cmds",
                    "ns_per_real_cmd", "per_width", "ladder", "serving",
                    "lm", "train", "split", "mesh_lm"):
            if key in k:
                line[-1][key] = k[key]
    record["kernels"] = line
    order = sorted(line, key=lambda k: -k["rank_ms"])
    print("[11] launches x (kernel ms - bound ms) per call: " + ", ".join(
        f"{k['name']} {k['rank_ms']:.4f}" for k in order))
    record["launches_fast_path"] = counts_fast
    record["launches_bank"] = counts_bank
    record["launches_matmul"] = counts_mm
    record["launches_fault"] = counts_fault
    record["launches_ladder"] = counts_ladder
    record["launches_apps"] = counts_apps
    record["launches_serving"] = counts_serve
    record["launches_lm"] = counts_lm
    record["launches_train"] = counts_train
    record["launches_examples"] = counts_examples
    record["launches_split"] = counts_split
    record["launches_mesh_lm"] = counts_mesh
    record["profiler_misses"] = PROFILER_MISSES
    print(f"[11] kernel times the profiler missed (timed by CUDA events): "
          f"{len(PROFILER_MISSES)}")
    return record


def matmul_phase(dev, record: dict, probe_libs: dict):
    """Phase 5: the bit-serial matmul path on K4.  Returns the kernel's
    entry and the launch counts of the path's run."""
    import torch

    import popmma_probe
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.bitserial_matmul import (binary_matmul,
                                                      bitserial_planes)
    from repro_torch.kernels.ref import (binary_matmul_ref,
                                         bitserial_planes_ref)

    gen = torch.Generator(device=dev).manual_seed(5)
    mats = {}
    for name, m, k, n in VGG16_SHAPES:
        mats[name] = (
            torch.randint(0, 4, (m, k), generator=gen, device=dev,
                          dtype=torch.int32),       # 2-bit unsigned
            torch.randint(-2, 2, (k, n), generator=gen, device=dev,
                          dtype=torch.int32))       # 2-bit signed
    rng = np.random.default_rng(5)
    q1_np = (rng.integers(0, 2, (512, 256)).astype(np.int32),
             rng.integers(0, 2, (256, 128)).astype(np.int32))
    q4_np = (rng.integers(0, 16, (512, 1024)).astype(np.int32),
             rng.integers(-8, 8, (1024, 128)).astype(np.int32))
    q1 = [torch.from_numpy(x).to(dev) for x in q1_np]
    q4 = [torch.from_numpy(x).to(dev) for x in q4_np]
    torch.cuda.synchronize()

    build.reset_launches()
    t0 = time.perf_counter()
    prods = {name: kops.bitserial_matmul(a, w, 2, 2)
             for name, (a, w) in mats.items()}
    q1_out = kops.quantized_matmul(*q1, 1, 1)       # bit-serial branch
    q4_out = kops.quantized_matmul(*q4, 4, 4)       # 16-bit limb branch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    # one fused K4 launch per product, all plane pairs inside it
    check(counts["popmatmul"] == len(VGG16_SHAPES) + 1,
          f"expected {len(VGG16_SHAPES) + 1} K4 launches, got "
          f"{counts['popmatmul']}")

    # exact integer oracles: a float64 product on the card is exact here
    # (|sums| <= K * 3 * 2 < 2**53), and 64 rows of each on the host in
    # int64
    for name, (a, w) in mats.items():
        got = prods[name]
        exact = (a.double() @ w.double()).to(torch.int64)
        check(torch.equal(got.to(torch.int64), exact),
              f"bitserial_matmul at {name} disagrees with the exact product")
        host = a[:64].cpu().numpy().astype(np.int64) @ \
            w.cpu().numpy().astype(np.int64)
        check(np.array_equal(got[:64].cpu().numpy(), host),
              f"bitserial_matmul at {name} disagrees with numpy")
    check(np.array_equal(q1_out.cpu().numpy(),
                         q1_np[0].astype(np.int64) @ q1_np[1]),
          "quantized_matmul 1x1 disagrees with numpy")
    check(np.array_equal(q4_out.cpu().numpy(),
                         q4_np[0].astype(np.int64) @ q4_np[1]),
          "quantized_matmul 4x4 disagrees with numpy")
    check(torch.equal(kops.bitserial_matmul(*q4, 4, 4), q4_out),
          "the bit-serial and limb routes disagree at 4x4 bits")
    # the 1 x 1-bit product's K4 launch against the plain version, which
    # the same entry point runs on CPU tensors
    errs_k4 = [max_abs_err(q1_out, kops.quantized_matmul(
        *[x.cpu() for x in q1], 1, 1).to(dev))]
    check(errs_k4[0] == 0, "quantized_matmul 1x1 disagrees with its plain "
          "version")
    print(f"[5] bitserial_matmul 2x2 bits at VGG-16 "
          f"{', '.join(n for n, *_ in VGG16_SHAPES)}: exact; "
          f"quantized_matmul 1x1 (K4) and 4x4 (16-bit limbs) exact; "
          f"{wall:.3f} s host wall; launches {counts}")

    # the units K4 could run on: binary MACs a second, fed from registers
    # (experiments/popmma_probe.py); the bound takes the fastest exact one
    rates = popmma_probe.peak_rates(probe_libs, time_ms)
    record["k4_unit_rates"] = rates
    units = {u: (r["macs_per_s"], f"{r['label']}, measured")
             for u, r in rates.items() if "macs_per_s" in r}
    units["int8_data_sheet"] = (INT8_MACS_PER_S,
                                "int8 tensor cores, data sheet")
    best = max(units, key=lambda u: units[u][0])
    unit_rate, unit_label = units[best]
    record["k4_bound_unit"] = {"unit": best, "label": unit_label,
                               "macs_per_s": unit_rate}
    print("[5] K4's candidate units, binary MACs/s (measured, fed from "
          "registers): " + ", ".join(
              f"{u} {r['macs_per_s'] / 1e12:.1f} T" if "macs_per_s" in r
              else f"{u} refused by nvcc ({r['refused'].splitlines()[-1]})"
              for u, r in rates.items())
          + f"; int8 data sheet {INT8_MACS_PER_S / 1e12:.1f} T; the bound "
          f"takes {best} ({unit_label})")

    # K4 at each shape: the path's fused 2 x 2-bit product (the launch the
    # path makes) against its plain version and torch._int_mm on the
    # 2-bit values, and one binary product (plane 0 of each operand)
    # against torch._int_mm on the bits; bounds: A and W read once, out
    # written once, and the binary MACs over the fastest unit
    per_shape = {}
    entry = None
    iw = torch.arange(2, dtype=torch.int32, device=dev)
    for name, (a, w) in mats.items():
        m, n = a.shape[0], w.shape[1]
        a_pl = kops._pack_bits_matrix((a >> iw[:, None, None]) & 1, 2)
        w_pl = kops._pack_bits_matrix(((w & 3) >> iw[:, None, None]) & 1, 1)
        kw = a_pl.shape[2]
        fused = bitserial_planes(a_pl, w_pl, False, True)
        a8, w8 = a.to(torch.int8), w.to(torch.int8)
        check(torch.equal(fused, torch._int_mm(a8, w8)),
              f"K4 (fused) and torch._int_mm disagree at {name}")
        fused_out = torch.empty_like(fused)
        fused_bare = (lambda: build.launch(
            "popmatmul", "popmatmul_launch", a_pl.data_ptr(),
            w_pl.data_ptr(), fused_out.data_ptr(), m, n, kw, 2, 2, 0, 1))
        row = {
            "shape": f"{name}: M={m}, K={32 * kw}, N={n}, 2 x 2 bits "
                     f"(4 plane pairs, one launch)",
            "ms": time_ms(lambda: bitserial_planes(a_pl, w_pl, False, True),
                          20),
            "device_ms": time_ms(fused_bare, 20),
            "kernel_ms": kernel_ms(fused_bare, 20, "popmatmul_kernel"),
            "launch_host_ms": host_ms(fused_bare, 20),
            "library_ms": time_ms(lambda: torch._int_mm(a8, w8), 20),
            "n_calls": 1,
            "bound": bound(4 * (2 * m * kw + 2 * kw * n + m * n),
                           4 * m * n * 32 * kw, unit_rate),
        }
        # one binary product
        ap, wp = a_pl[0], w_pl[0]
        out = binary_matmul(ap, wp)
        a1, w1 = (a & 1).to(torch.int8), (w & 1).to(torch.int8)
        check(torch.equal(torch._int_mm(a1, w1), out),
              f"K4 and torch._int_mm disagree at {name}")
        one_bare = (lambda: build.launch(
            "popmatmul", "popmatmul_launch", ap.data_ptr(), wp.data_ptr(),
            out.data_ptr(), m, n, kw, 1, 1, 0, 0))
        row["binary"] = {
            "kernel_ms": kernel_ms(one_bare, 20, "popmatmul_kernel"),
            "device_ms": time_ms(one_bare, 20),
            "library_ms": time_ms(lambda: torch._int_mm(a1, w1), 20),
            "bound": bound(4 * (m * kw + kw * n + m * n), m * n * 32 * kw,
                           unit_rate),
        }
        err = max(max_abs_err(fused, bitserial_planes_ref(a_pl, w_pl,
                                                           False, True)),
                  max_abs_err(out, binary_matmul_ref(ap, wp)))
        check(err == 0, f"K4 disagrees with its plain versions at {name}")
        errs_k4.append(err)
        row["max_abs_err"] = err
        if name == "conv3_2":
            row["plain_ms"] = time_ms(
                lambda: bitserial_planes_ref(a_pl, w_pl, False, True), 1,
                warmup=0)
            entry = row
        per_shape[name] = row
        one = row["binary"]
        print(f"[5] K4 at {row['shape']}: kernel {row['kernel_ms']:.4f} ms "
              f"(profiler; bare launch {row['device_ms']:.4f}, wrapper "
              f"{row['ms']:.4f} by events), torch._int_mm "
              f"{row['library_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
              f"({row['bound'][1]}); one binary product: kernel "
              f"{one['kernel_ms']:.4f} ms, torch._int_mm "
              f"{one['library_ms']:.4f} ms, bound {one['bound'][0]:.4f} ms "
              f"({one['bound'][1]})")
    record["k4_per_shape"] = per_shape
    record["matmul_wall_s"] = wall
    # the path's launches are the three fused products and the 1 x 1-bit
    # product, each compared above
    entry["agreement"] = {}
    _agree(entry["agreement"], "matmul", counts["popmatmul"], errs_k4)
    entry["max_abs_err"] = max(errs_k4)
    b = device_breakdown(lambda: [kops.bitserial_matmul(a, w, 2, 2)
                                  for a, w in mats.values()])
    record["matmul_breakdown"] = b
    print(f"[5] profiled repeat of the three products: wall "
          f"{b['wall_ms']:.2f} ms, device busy {b['device_busy_ms']:.3f} ms, "
          f"idle share {b['idle_share']:.4f}; device ms "
          f"{json.dumps(b['device_ms'])}")
    return entry, counts


def fault_phase(dev, record: dict, mix_queue):
    """Phase 6: the fault-injected bank dispatch on K6.  Returns the
    kernel's entry and the launch counts of the path's run."""
    import torch

    from repro_torch.core import bank as bank_mod
    from repro_torch.core.bank import Bank, flatten_result, plan_queue
    from repro_torch.core.control_unit import (faulty_bank_replay,
                                               faulty_replay_plain,
                                               flip_threshold)
    from repro_torch.core.fault import (FaultExhaustedError, FaultModel,
                                        FaultRuntime, replicate_queue)
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.ops_library import get_op
    from repro_torch.core.timing import DDR4
    from repro_torch.kernels import build

    n_units = DDR4.n_banks * DDR4.subarrays_per_bank
    fmix = mix_queue(bank_mod, get_op, FAULT_LANES)
    # the paper's sigma; at 32,768 lanes x 32 instructions the default 3
    # retries leave lanes undecided (ROADMAP Queue 3), so 10 are allowed
    model = FaultModel(sigma=0.15, spare_lanes=1, seed=0, max_retries=10)
    p_flip = model.flip_probability()      # the reliability Monte-Carlo

    build.reset_launches()
    t0 = time.perf_counter()
    with _RecordedInterpreter(bank_mod, "faulty_batched_interpreter") as rec:
        fdev = SimdramDevice(backend="bank", device=dev, fault=model)
        res = fdev.dispatch(fmix)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    check(len(rec) == counts["faulty_replay"],
          f"{len(rec)} faulty runs for {counts['faulty_replay']} K6 launches")
    # K6 against its plain version on every attempt of this run
    errs_k6 = [_k6_attempt(dev, args, timed=False)[0] for args in rec]
    fs = fdev.bank().stats.faults
    check(counts["faulty_replay"] > 0, "the fault path did not launch K6")

    clean = SimdramDevice(backend="bank", device=dev).dispatch(fmix)
    wrong = {}
    for i, ins in enumerate(fmix):
        spec = get_op(ins.op, ins.n_bits)
        check(masked_equal(clean[i], spec.oracle(*ins.operands),
                           spec.out_bits),
              f"fault-free instruction {i} is wrong")
        for g, e in zip(flatten_result(res[i]), flatten_result(clean[i])):
            g, e = (np.asarray(x).astype(np.int64) for x in (g, e))
            bad = g != e
            if bad.any():   # the lane count and the first XOR patterns
                wrong[f"{i} {ins.op}/{ins.n_bits}"] = [
                    int(bad.sum()), (g[bad] ^ e[bad])[:4].tolist()]
    n_wrong = sum(n for n, _ in wrong.values())
    check(n_wrong <= WRONG_LANE_SHARE * len(fmix) * FAULT_LANES,
          f"{n_wrong} lanes differ from the fault-free dispatch: {wrong}")
    seed0 = {"wrong_lanes": n_wrong,
             "faulty_replay_launches": counts["faulty_replay"]}
    record["sigma_seed0"] = seed0
    check(seed0 == SIGMA_SEED0, f"the sigma = 0.15 run at fault seed 0 "
          f"gave {seed0}, not {SIGMA_SEED0} as before the redesign")
    check(fs.injected > 0 and fs.detected > 0 and fs.corrected > 0,
          f"faults were not injected, detected and corrected: {fs}")
    record["fault_stats"] = fs.as_dict()
    record["fault_wall_s"] = wall
    record["fault_wrong_lanes"] = wrong
    print(f"[6] fault-injected bank dispatch, sigma=0.15 (p_flip "
          f"{p_flip:g}), 1 spare lane, {len(fmix)} x {FAULT_LANES} lanes, "
          f"{wall:.3f} s host wall: {n_wrong} lanes differ from the "
          f"fault-free dispatch (replicas corrupted alike) {wrong}; "
          f"launches {counts}")
    print(f"[6] FaultStats {json.dumps(fs.as_dict())}")

    # dead units: the first seed that draws one; p_flip = 0, so the only
    # damage is the garbage, which blacklisting must route around
    seed = next(s for s in range(1000) if FaultRuntime(
        FaultModel(dead_unit_rate=0.1, seed=s), (), n_units).dead.any())
    dmodel = FaultModel(p_flip=0.0, dead_unit_rate=0.1, spare_lanes=1,
                        seed=seed)
    ddev = SimdramDevice(backend="bank", device=dev, fault=dmodel)
    res_d = ddev.dispatch(fmix)
    dfs = ddev.bank().stats.faults
    check(all(np.array_equal(g, e) for r, c in zip(res_d, clean)
              for g, e in zip(flatten_result(r), flatten_result(c))),
          "the dead-unit dispatch differs from the fault-free one")
    check(dfs.detected > 0 and dfs.redispatches > 0 and dfs.remapped > 0,
          f"dead units were not detected and remapped: {dfs}")
    record["dead_unit_stats"] = dfs.as_dict()
    print(f"[6] dead units (seed {seed}, units "
          f"{np.nonzero(ddev.bank()._fault_rt.dead)[0].tolist()}): exact "
          f"after blacklisting; FaultStats {json.dumps(dfs.as_dict())}")

    # stuck columns with flips: a lane with a stuck replica needs both
    # others clean in one attempt, which 1e-3 flips on 16-bit
    # multiplication rarely allow, so every unit is blacklisted and the
    # dispatch raises FaultExhaustedError (cause no_capacity), as the
    # reference does at every fault seed experiments/fault_share.py ran.
    # A dispatch that returns must be exact.
    smix = mix_queue(bank_mod, get_op, STUCK_LANES)
    smodel = FaultModel(p_flip=1e-3, stuck_lane_rate=0.02, spare_lanes=2,
                        seed=0)
    sdev = SimdramDevice(backend="bank", device=dev, fault=smodel)
    try:
        res_s = sdev.dispatch(smix)
        check(all(masked_equal(res_s[i], get_op(ins.op, ins.n_bits).oracle(
            *ins.operands), get_op(ins.op, ins.n_bits).out_bits)
            for i, ins in enumerate(smix)), "the stuck run returned wrong "
            "lanes")
        outcome = {"outcome": "returned", "wrong_lanes": 0}
    except FaultExhaustedError as e:
        outcome = {"outcome": "exhausted", **e.context()}
        check(e.cause == "no_capacity" and len(e.blacklist) == n_units,
              f"the stuck run exhausted otherwise than the reference: "
              f"{outcome}")
    sfs = sdev.bank().stats.faults
    check(sfs.detected > 0 and sfs.redispatches > 0 and sfs.remapped > 0,
          f"stuck columns were not detected and remapped: {sfs}")
    record["stuck_run"] = {**outcome, "stats": sfs.as_dict()}
    print(f"[6] stuck columns 0.02 + p_flip 1e-3, 2 spare lanes, "
          f"{len(smix)} x {STUCK_LANES} lanes: {json.dumps(outcome)}; "
          f"FaultStats {json.dumps(sfs.as_dict())}")

    # K6 against its plain version on every wave of the main path's
    # replicated queue, with its p_flip, seed-0 keys, the stuck run's
    # masks and the dead-unit run's dead units: all three failure modes
    bank = Bank(n_subarrays=n_units, device=dev)
    rep = replicate_queue(fmix, model.replicas)
    q_lanes, stage, _ = plan_queue(rep)
    waves = bank._build_waves(rep, list(range(len(rep))), stage, q_lanes)
    rt = FaultRuntime(model, (), n_units)
    s0_all, s1_all = FaultRuntime(smodel, (), n_units).stuck_masks(2048)
    dead = torch.from_numpy(ddev.bank()._fault_rt.dead.copy()).to(dev)
    thr = flip_threshold(p_flip)
    k6 = {"max_abs_err": 0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
          "bytes": 0, "ops": 0, "wave_device_ms": [], "wave_kernel_ms": [],
          "longest_unit_cmds": [], "ns_per_real_cmd": []}
    flips = 0
    for wave in waves:
        states_np, ct, _ = bank._pack_wave(rep, wave, q_lanes, {})
        tables, schedule = ct
        states = torch.from_numpy(states_np.view(np.int32)).to(dev)
        n_rows, w_words = states.shape[1:]
        keys = torch.from_numpy(rt.draw_keys().view(np.int32)).to(dev)
        s0 = torch.from_numpy(s0_all[:, :w_words].view(np.int32)).to(dev)
        s1 = torch.from_numpy(s1_all[:, :w_words].view(np.int32)).to(dev)
        args = (states, tables, keys, s0, s1, dead, p_flip)
        out_k, n_k = faulty_bank_replay(states, ct, *args[2:])
        t_plain = time.perf_counter()
        out_p, n_p = faulty_replay_plain(*args)
        torch.cuda.synchronize()
        k6["plain_ms"] += (time.perf_counter() - t_plain) * 1e3
        err = max(max_abs_err(out_k, out_p), max_abs_err(n_k, n_p))
        check(err == 0, "K6 disagrees with its plain version")
        errs_k6.append(err)
        flips += int(n_k.sum())
        out = torch.empty_like(states)
        cnt = torch.zeros(n_units, dtype=torch.int64, device=dev)
        n_cmds = tables.shape[1]
        k6["ms"] += time_ms(
            lambda: faulty_bank_replay(states, ct, *args[2:]), 10)
        bare = (lambda: build.launch(
            "replay", "faulty_replay_launch", states.data_ptr(),
            out.data_ptr(), tables.data_ptr(), n_cmds * 13,
            schedule.data_ptr(), keys.data_ptr(), s0.data_ptr(),
            s1.data_ptr(), dead.data_ptr(), cnt.data_ptr(), thr, n_units,
            n_rows, w_words, n_cmds))
        wave_ms = time_ms(bare, 10)
        k6["device_ms"] += wave_ms
        k6["wave_kernel_ms"].append(
            kernel_ms(bare, 10, "faulty_replay_kernel"))
        k6["launch_host_ms"] = host_ms(bare, 10)
        k6["ops"] += replay_ops_per_word(
            tables.cpu().numpy(), schedule[0].cpu().numpy(), thr) * w_words
        k6["bytes"] += (2 * states.numel() * 4 + keys.numel() * 4
                        + 2 * s0.numel() * 4 + n_units + n_units * 8)
        add_replay_wave(k6, wave_ms, tables, schedule)
    check(flips > 0, "the K6 comparison drew no flips")
    k6["agreement"] = {}
    _agree(k6["agreement"], "faulty bank", counts["faulty_replay"], errs_k6)
    k6["kernel_ms"] = sum(k6["wave_kernel_ms"])
    k6["n_calls"] = len(waves)
    k6["bound"] = bound(k6["bytes"], k6["ops"])
    k6["shape"] = (f"sum over the replicated mix queue's {len(waves)} waves, "
                   f"{n_units} units x {32 * w_words} columns, p_flip "
                   f"{p_flip:g}, stuck masks, {int(dead.sum())} dead "
                   f"unit(s)")
    print(f"[6] K6 vs plain on {len(waves)} waves ({flips} flips): "
          f"bit-exact, states and flip counts; kernel total "
          f"{k6['ms']:.3f} ms, per wave (device) "
          f"{fmt_list(k6['wave_device_ms'])} ms, (profiler) "
          f"{fmt_list(k6['wave_kernel_ms'])} ms at longest real counts "
          f"{k6['longest_unit_cmds']} ({fmt_list(k6['ns_per_real_cmd'])} "
          f"ns per command); plain {k6['plain_ms']:.0f} ms, bound "
          f"{k6['bound'][0]:.4f} ms ({k6['bound'][1]})")

    # a disabled model costs nothing: no K6 launch, the fault-free replay
    before = dict(build.LAUNCHES)
    off = SimdramDevice(backend="bank", device=dev,
                        fault=FaultModel(enabled=False))
    res_off = off.dispatch(fmix)
    torch.cuda.synchronize()
    check(build.LAUNCHES["faulty_replay"] == before["faulty_replay"]
          and build.LAUNCHES["replay"] > before["replay"],
          "a disabled fault model launched K6 or skipped K5")
    check(all(np.array_equal(g, e) for r, c in zip(res_off, clean)
              for g, e in zip(flatten_result(r), flatten_result(c))),
          "the disabled-model dispatch differs from the fault-free one")
    print("[6] FaultModel(enabled=False): no K6 launch, results equal")

    # where a fault-injected dispatch's wall goes: the same run again (a
    # new device draws the same faults) under the profiler
    b = device_breakdown(lambda: SimdramDevice(
        backend="bank", device=dev, fault=model).dispatch(fmix))
    record["fault_breakdown"] = b
    note_profiled("6", "faulty_replay_kernel", b)
    print(f"[6] profiled fault dispatch: wall {b['wall_ms']:.2f} ms, device "
          f"busy {b['device_busy_ms']:.3f} ms, idle share "
          f"{b['idle_share']:.4f}; device ms {json.dumps(b['device_ms'])}")
    return k6, counts


def _recording(executor, calls: list):
    """``executor`` with a ``run`` that keeps the arguments of every call
    in ``calls``."""
    run = executor.run

    def rec(*args):
        calls.append(args)
        return run(*args)

    return dataclasses.replace(executor, run=rec)


class _RecordedInterpreter:
    """Within ``with``: the bank's replay interpreter factory ``name`` in
    ``bank_mod`` (``hetero_batched_interpreter`` or
    ``faulty_batched_interpreter``) makes callables that keep the
    arguments of every call in ``calls``."""

    def __init__(self, bank_mod, name: str):
        self.mod, self.name, self.calls = bank_mod, name, []

    def __enter__(self):
        make = self.made = getattr(self.mod, self.name)

        def recording(device):
            run = make(device)

            def rec(*args):
                self.calls.append(args)
                return run(*args)
            return rec

        setattr(self.mod, self.name, recording)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.made)


def _flat(results):
    from repro_torch.core.bank import flatten_result
    return [np.asarray(x) for r in results for x in flatten_result(r)]


def _agree(agreement: dict, path: str, launches: int, errs: list) -> None:
    """Record a path's agreement with the plain version: its launches on
    the path, the calls held against the plain version at the path's
    shapes and their largest error."""
    agreement[path] = {"launches": int(launches), "compared": len(errs),
                       "max_abs_err": max(errs, default=0)}


def _chain_transposes(dev, chain, chain_raw, results, values) -> dict:
    """K1 on the chain queue's entry operand and K2 on each of its
    vertical results, against their plain versions on the same inputs:
    ``{"h2v": [max_abs_err], "v2h": [max_abs_err per result]}``."""
    import torch

    from repro_torch.core.bank import VerticalOperand
    from repro_torch.core.bitplane import host_i32
    from repro_torch.kernels.transpose_kernel import h2v_plain, v2h_plain
    entry = chain[1].operands[1]
    check(isinstance(entry, VerticalOperand) and len(values) == len(results),
          "the chain queue lost its vertical entry operand")
    z = torch.from_numpy(host_i32(chain_raw[0][2])).to(dev)
    planes = torch.from_numpy(entry.planes.view(np.int32)).to(dev)
    errs = {"h2v": [max_abs_err(planes, h2v_plain(z, planes.shape[0]))],
            "v2h": []}
    for r, v in zip(results, values):
        if isinstance(r, VerticalOperand):
            pl = torch.from_numpy(np.ascontiguousarray(
                r.planes, dtype=np.uint32).view(np.int32)).to(dev)
            errs["v2h"].append(max_abs_err(
                torch.from_numpy(np.asarray(v)).to(dev),
                v2h_plain(pl)[:r.lanes]))
    check(errs["v2h"] and max(errs["h2v"] + errs["v2h"]) == 0,
          f"K1/K2 on the chain queue disagree with plain: {errs}")
    return errs


def _k5_round_ms(states, tables, schedule, reps: int = 5,
                 profiler: bool = True):
    """K5's kernel-only ms (profiler; with ``profiler=False`` the device
    ms of back-to-back bare launches, CUDA events) on one round's
    (n_units, n_rows, n_words) int32 states and its tables (one a unit,
    or one shared) with their schedule, and its bound: (ms, (bound ms,
    by))."""
    import torch

    from repro_torch.core.control_unit import CMD_WIDTH
    from repro_torch.kernels import build
    n_units, n_rows, n_words = states.shape
    n_cmds = tables.shape[-2]
    stride = 0 if tables.dim() == 2 else n_cmds * CMD_WIDTH
    out = torch.empty_like(states)
    bare = (lambda: build.launch(
        "replay", "replay_launch", states.data_ptr(), out.data_ptr(),
        tables.data_ptr(), stride, schedule.data_ptr(), n_units, n_rows,
        n_words, n_cmds))
    ms = (kernel_ms(bare, reps, "replay_kernel") if profiler
          else time_ms(bare, reps))
    counts = schedule[0].cpu().numpy()
    per_unit = tables if tables.dim() == 3 else tables.expand(
        n_units, *tables.shape)
    n_bytes = 2 * states.numel() * 4 + int(counts.sum()) * CMD_WIDTH * 4
    n_ops = replay_ops_per_word(per_unit.cpu().numpy(), counts) * n_words
    return ms, bound(n_bytes, n_ops)


def _round_k5(dev, states_np, ct, reps: int = 5):
    """One captured stacked round (or bank wave) through K5, held against
    the plain replay on the same inputs: (kernel ms by the profiler,
    (bound ms, by), max_abs_err, plain s, the states tensor)."""
    import torch

    from repro_torch.core.control_unit import replay, replay_plain
    tables, schedule = ct
    n_rows, n_words = states_np.shape[-2:]
    states = torch.from_numpy(np.ascontiguousarray(
        states_np.reshape(-1, n_rows, n_words)).view(np.int32)).to(dev)
    ms, bnd = _k5_round_ms(states, tables, schedule, reps)
    out_k = replay(states, ct)
    t_plain = time.perf_counter()
    # up to the longest real command count: the NOPs after it change
    # nothing (tests/test_torch_replay_lengths.py)
    out_p = replay_plain(states, tables[..., :int(schedule[0].max()), :])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t_plain
    err = max_abs_err(out_k, out_p)
    check(err == 0, f"K5 disagrees with the plain replay on a "
          f"{tuple(states.shape)} round")
    return ms, bnd, err, plain_s, states


def _k6_attempt(dev, args, reps: int = 5, timed: bool = True):
    """One captured attempt of a faulty round (or bank wave) through a
    bare K6 launch over its inputs flattened to one unit axis, held
    against the plain version on the same inputs, states and flip counts:
    (max_abs_err, plain s, kernel ms by the profiler, (bound ms, by)),
    the last two ``None`` unless ``timed``."""
    import torch

    from repro_torch.core.control_unit import (CMD_WIDTH, faulty_replay_plain,
                                               flip_threshold)
    from repro_torch.kernels import build
    states, ct, keys, s0, s1, dead, p_flip = args
    tables, schedule = ct
    n_rows, n_words = states.shape[-2:]
    st = states.reshape(-1, n_rows, n_words).contiguous()
    n_units, n_cmds = st.shape[0], tables.shape[1]
    k = keys.reshape(n_units, 2).contiguous()
    m0 = s0.reshape(n_units, n_words).contiguous()
    m1 = s1.reshape(n_units, n_words).contiguous()
    dd = dead.reshape(n_units).to(torch.bool).contiguous()
    out = torch.empty_like(st)
    cnt = torch.zeros(n_units, dtype=torch.int64, device=dev)
    thr = flip_threshold(p_flip)
    bare = (lambda: build.launch(
        "replay", "faulty_replay_launch", st.data_ptr(), out.data_ptr(),
        tables.data_ptr(), n_cmds * CMD_WIDTH, schedule.data_ptr(),
        k.data_ptr(), m0.data_ptr(), m1.data_ptr(), dd.data_ptr(),
        cnt.data_ptr(), thr, n_units, n_rows, n_words, n_cmds))
    bare()
    t_plain = time.perf_counter()
    out_p, cnt_p = faulty_replay_plain(
        st, tables[:, :int(schedule[0].max())], k, m0, m1, dd, p_flip)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t_plain
    err = max(max_abs_err(out, out_p), max_abs_err(cnt, cnt_p))
    check(err == 0, f"K6 disagrees with its plain version on a "
          f"{tuple(st.shape)} attempt")
    del out_p, cnt_p
    if not timed:
        return err, plain_s, None, None
    counts = schedule[0].cpu().numpy()
    n_bytes = (2 * st.numel() * 4 + k.numel() * 4 + 2 * m0.numel() * 4
               + n_units + n_units * 8 + int(counts.sum()) * CMD_WIDTH * 4)
    n_ops = replay_ops_per_word(tables.cpu().numpy(), counts, thr) * n_words
    return (err, plain_s, kernel_ms(bare, reps, "faulty_replay_kernel"),
            bound(n_bytes, n_ops))


def _k6_bare(st, tables, schedule, keys, stuck0, stuck1, dead, p_flip):
    """One bare K6 launch over flattened inputs: (states, flip counts)."""
    import torch

    from repro_torch.core.control_unit import CMD_WIDTH, flip_threshold
    from repro_torch.kernels import build
    n_units, n_rows, n_words = st.shape
    n_cmds = tables.shape[1]
    out = torch.empty_like(st)
    cnt = torch.zeros(n_units, dtype=torch.int64, device=st.device)
    build.launch(
        "replay", "faulty_replay_launch", st.data_ptr(), out.data_ptr(),
        tables.data_ptr(), n_cmds * CMD_WIDTH, schedule.data_ptr(),
        keys.data_ptr(), stuck0.data_ptr(), stuck1.data_ptr(),
        dead.data_ptr(), cnt.data_ptr(), flip_threshold(p_flip), n_units,
        n_rows, n_words, n_cmds)
    return out, cnt


def _stacked_plain(members, plain) -> tuple:
    """Launches held against their plain version, those of one group in
    one plain call: ``members`` are ``(group, inputs, outs)``, ``inputs``
    a launch's ``(states, tables, *per-unit tensors)`` on one unit axis
    (tables cut at their longest real command count) and ``outs`` its
    outputs; ``plain(group, states, tables, *rest)`` returns the plain
    outputs of a group's inputs stacked along the unit axis (units share
    nothing, and the all-zero rows that pad a table to the longest change
    nothing).  Returns (max_abs_err per member, plain s per group)."""
    import torch
    groups: dict = {}
    for i, (key, inputs, outs) in enumerate(members):
        groups.setdefault(key, []).append((i, inputs, outs))
    errs = [None] * len(members)
    plain_s = []
    for key, grp in groups.items():
        n_cmds = max(inp[1].shape[1] for _, inp, _ in grp)
        tables = torch.cat([torch.nn.functional.pad(
            inp[1], (0, 0, 0, n_cmds - inp[1].shape[1])) for _, inp, _ in grp])
        rest = [torch.cat([inp[j] for _, inp, _ in grp])
                for j in range(2, len(grp[0][1]))]
        t0 = time.perf_counter()
        outs_p = plain(key, torch.cat([inp[0] for _, inp, _ in grp]), tables,
                       *rest)
        if outs_p[0].is_cuda:
            torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
        lo = 0
        for i, inp, outs in grp:
            hi = lo + inp[0].shape[0]
            errs[i] = max(max_abs_err(o, o_p[lo:hi])
                          for o, o_p in zip(outs, outs_p))
            lo = hi
        del outs_p
    return errs, plain_s


def _k6_batched(dev, attempts) -> list:
    """Each of ``attempts`` (a faulty executor's recorded calls) through a
    bare K6 launch, held against the plain version on the same inputs,
    states and flip counts, as :func:`_k6_attempt` does; the plain
    version takes the attempts of one state shape and flip rate at once
    (:func:`_stacked_plain`).  Returns (max_abs_err per attempt, plain s
    per group)."""
    import torch

    from repro_torch.core.control_unit import faulty_replay_plain
    members = []
    for states, ct, keys, s0, s1, dead, p_flip in attempts:
        tables, schedule = ct
        n_rows, n_words = states.shape[-2:]
        st = states.reshape(-1, n_rows, n_words).contiguous()
        n_units = st.shape[0]
        k = keys.reshape(n_units, 2).contiguous()
        m0 = s0.reshape(n_units, n_words).contiguous()
        m1 = s1.reshape(n_units, n_words).contiguous()
        dd = dead.reshape(n_units).to(torch.bool).contiguous()
        outs = _k6_bare(st, tables, schedule, k, m0, m1, dd, p_flip)
        members.append(((n_rows, n_words, float(p_flip)),
                        (st, tables[:, :int(schedule[0].max())], k, m0, m1,
                         dd), outs))
    errs, plain_s = _stacked_plain(
        members, lambda key, st, tables, *rest: faulty_replay_plain(
            st, tables, *rest, key[2]))
    check(max(errs) == 0, f"K6 disagrees with its plain version: {errs}")
    return errs, plain_s


def ladder_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 7: the chip, channel and rank tiers at full width, and the
    fault wrappers of the chip and channel.  Adds the ladder's rounds to
    K5's and K6's entries and returns the launch counts of the tiers'
    counted runs, summed."""
    import torch

    from repro_torch.core import bank as bank_mod
    from repro_torch.core.channel import sequential_channel_dispatch
    from repro_torch.core.chip import sequential_dispatch
    from repro_torch.core.control_unit import TABLE_CACHE
    from repro_torch.core.fault import FaultModel, FaultRuntime
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.ops_library import get_op
    from repro_torch.core.rank import sequential_rank_dispatch
    from repro_torch.core.timing import DDR4
    from repro_torch.kernels import build

    lanes = DDR4.columns_per_subarray
    per_unit = DDR4.n_banks * DDR4.subarrays_per_bank
    total = {k: 0 for k in build.LAUNCHES}
    k5_ladder, k6_ladder, rows = {}, {}, {}
    agreement = {name: kern[name].setdefault("agreement", {})
                 for name in ("h2v", "v2h", "replay", "faulty_replay")}
    for tier, n_chips, n_channels in LADDER:
        cfg = dataclasses.replace(DDR4, n_chips=n_chips,
                                  n_channels=n_channels)
        units = n_channels * n_chips * per_unit
        mix = mix_queue(bank_mod, get_op, lanes, n_instrs=2 * units)
        rng = np.random.default_rng(7)
        x, y = (rng.integers(0, 256, units * lanes) for _ in range(2))

        # the counted run: the mix queue, the chain queue, one bbop over
        # every lane of the tier
        build.reset_launches()
        cache0 = TABLE_CACHE.stats()
        t0 = time.perf_counter()
        tdev = SimdramDevice(cfg=cfg, backend=tier, device=dev)
        chain, chain_raw = chain_queue(bank_mod, lanes, dev)
        res_mix = tdev.dispatch(mix)
        raw_chain = tdev.dispatch(chain)
        res_chain = _flat(raw_chain)                      # relu via K2
        got = tdev.bbop("addition", x, y, n_bits=8)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = dict(build.LAUNCHES)
        cache1 = TABLE_CACHE.stats()
        eng = getattr(tdev, tier)()
        st = eng.stats
        n_rounds = st.rounds if tier == "chip" else st.super_rounds
        check(counts["replay"] == n_rounds,
              f"{tier}: {counts['replay']} K5 launches for {n_rounds} "
              f"stacked rounds")
        check(counts["h2v"] > 0 and counts["v2h"] > 0
              and counts["faulty_replay"] == 0 and counts["circuit"] == 0,
              f"{tier}: unexpected launches {counts}")
        for k, v in counts.items():
            total[k] += v
        for name, errs in _chain_transposes(dev, chain, chain_raw, raw_chain,
                                            res_chain).items():
            _agree(agreement[name], tier, counts[name], errs)
        del raw_chain

        for i, ins in enumerate(mix):
            spec = get_op(ins.op, ins.n_bits)
            check(masked_equal(res_mix[i], spec.oracle(*ins.operands),
                               spec.out_bits),
                  f"{tier}: mix instruction {i} ({ins.op}/{ins.n_bits}) "
                  f"is wrong")
        mul, add, relu = (get_op(op, w) for op, w in (
            ("multiplication", 8), ("addition", 16), ("relu", 16)))
        for c, (cx, cy, cz) in enumerate(chain_raw):
            m = mul.oracle(cx, cy)[0]
            a = add.oracle(m, cz)[0]
            want = (m, a, relu.oracle(a)[0])
            check(all(masked_equal(res_chain[3 * c + j], (want[j],),
                                   (16,)) for j in range(3)),
                  f"{tier}: chain {c} is wrong")
        check(masked_equal(got, get_op("addition", 8).oracle(
            x.astype(np.uint64), y.astype(np.uint64)), (8,)),
            f"{tier}: the bbop over {units * lanes} lanes is wrong")
        geo = dict(n_banks=cfg.n_banks, n_subarrays=cfg.subarrays_per_bank,
                   cfg=cfg, device=dev)
        if tier == "chip":
            seq = lambda q: sequential_dispatch(q, **geo)[0]  # noqa: E731
        elif tier == "channel":
            seq = lambda q: sequential_channel_dispatch(  # noqa: E731
                q, n_chips=n_chips, **geo)[0]
        else:
            seq = lambda q: sequential_rank_dispatch(  # noqa: E731
                q, n_channels=n_channels, n_chips=n_chips, **geo)[0]
        for name, q, res in (("mix", mix, _flat(res_mix)),
                             ("chain", chain, res_chain)):
            check(all(np.array_equal(g, e) for g, e in zip(res, _flat(
                seq(q)))), f"{tier}: the {name} queue differs from the "
                f"sequential baseline")
        stats = st.as_dict()

        # warm: the same dispatches on the same engine (lane loads reset,
        # so the same placement), each round's inputs kept; the bbop's
        # round is kept too, after the timed repeat, so every round of the
        # counted run has its twin; then the mix dispatch once more under
        # the profiler
        eng.reset_stats()
        rounds: list = []
        executor = eng.executor
        eng.executor = _recording(executor, rounds)
        cache_w = TABLE_CACHE.stats()
        t0 = time.perf_counter()
        tdev.dispatch(mix)
        _flat(tdev.dispatch(chain))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_pack = eng.stats.pack_wall_s
        cache2 = TABLE_CACHE.stats()
        tdev.bbop("addition", x, y, n_bits=8)
        eng.executor = executor
        check(len(rounds) == n_rounds, f"{tier}: the repeat ran "
              f"{len(rounds)} rounds, the counted run {n_rounds}")
        eng.reset_stats()
        prof = device_breakdown(lambda: tdev.dispatch(mix))
        note_profiled(f"7 {tier}", "replay_kernel", prof)
        h2d_ms = sum(v for k, v in prof["device_ms"].items() if "HtoD" in k)

        # K5 on every round of the repeat, against the plain replay on the
        # same stack, and beside its bound
        per_round = []
        for states_np, ct in rounds:
            ms, bnd, err, plain_s, states = _round_k5(dev, states_np, ct)
            per_round.append({"kernel_ms": ms, "bound_ms": bnd[0],
                              "bound_by": bnd[1], "max_abs_err": err,
                              "plain_s": plain_s,
                              "units": int(states.shape[0]),
                              "rows": int(states.shape[1]),
                              "words": int(states.shape[2]),
                              "cmds": int(ct.tables.shape[1]),
                              "table_bytes": int(ct.tables.numel()) * 4})
            print(f"[7] {tier} round {len(per_round) - 1}: "
                  f"{json.dumps(per_round[-1])}", flush=True)
            del states
        _agree(agreement["replay"], tier, counts["replay"],
               [r["max_abs_err"] for r in per_round])
        print(f"[7] {tier}: K5 equals the plain replay bit for bit on all "
              f"{len(per_round)} rounds (plain " + ", ".join(
                  f"{r['plain_s']:.2f}" for r in per_round) + " s)")
        row = {
            "units": units, "lanes": units * lanes,
            "instructions": {"mix": len(mix), "chain": len(chain), "bbop": 1},
            "launches": counts, "rounds": n_rounds,
            "first_wall_s": first_s, "first_pack_wall_s": stats["pack_wall_s"],
            "warm_wall_s": warm_s, "warm_pack_wall_s": warm_pack,
            "table_cache": {
                "first": {k: cache1[k] - cache0[k]
                          for k in ("hits", "misses", "evictions")},
                "warm": {k: cache2[k] - cache_w[k]
                         for k in ("hits", "misses", "evictions")},
                "bytes": cache2["bytes"], "entries": cache2["entries"]},
            "profiled_mix": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "idle_share", "device_ms")},
            "h2d_ms": h2d_ms,
            "warm_rounds": per_round,
            "modeled": {k: stats[k] for k in stats if k in (
                "latency_s", "total_latency_s", "transfer_bytes",
                "transfer_s", "transfer_h2d_s", "transfer_d2h_s",
                "transfer_overlapped_s", "exposed_transfer_s",
                "crossover_chips", "transfer_bound", "elements")},
        }
        rows[tier] = row
        k5_ladder[tier] = {
            "launches": counts["replay"], "rounds": n_rounds,
            "round_kernel_ms": [r["kernel_ms"] for r in per_round],
            "round_bound_ms": [r["bound_ms"] for r in per_round],
            "round_plain_s": [r["plain_s"] for r in per_round]}
        print(f"[7] {tier} ({units} units, {units * lanes} lanes): mix "
              f"{len(mix)} + chain {len(chain)} instrs + one bbop match the "
              f"oracle and the sequential baseline; {n_rounds} rounds, "
              f"launches {counts}; first {first_s:.3f} s (pack "
              f"{stats['pack_wall_s']:.3f} s), warm {warm_s:.3f} s (pack "
              f"{warm_pack:.3f} s)")
        print(f"[7] {tier} table cache: first {row['table_cache']['first']}, "
              f"warm {row['table_cache']['warm']}, {cache2['bytes']} bytes in "
              f"{cache2['entries']} entries")
        print(f"[7] {tier} profiled mix dispatch: wall {prof['wall_ms']:.2f} "
              f"ms, card busy {prof['device_busy_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.4f}, host-to-device copies "
              f"{h2d_ms:.3f} ms; device ms {json.dumps(prof['device_ms'])}")
        print(f"[7] {tier} K5 per round (profiler): " + ", ".join(
            f"{r['kernel_ms']:.4f} ms ({r['units']} x {r['rows']} x "
            f"{r['words']}, {r['cmds']} cmds, tables "
            f"{r['table_bytes'] / 2**20:.1f} MiB; bound {r['bound_ms']:.4f} "
            f"{r['bound_by']})" for r in per_round))
        print(f"[7] {tier} modeled {json.dumps(row['modeled'])}")
        del rounds, res_mix, res_chain, got, tdev, eng

    # the fault wrappers: the chip and a 2-chip channel
    for tier, n_chips in LADDER_FAULT:
        cfg = dataclasses.replace(DDR4, n_chips=n_chips)
        units = n_chips * per_unit
        fmix = mix_queue(bank_mod, get_op, FAULT_LANES, n_instrs=2 * units)
        clean = _flat(SimdramDevice(cfg=cfg, backend=tier,
                                    device=dev).dispatch(fmix))
        want = [o for ins in fmix for o in get_op(ins.op, ins.n_bits).oracle(
            *ins.operands)]
        widths = [w for ins in fmix for w in get_op(ins.op, ins.n_bits).out_bits]
        check(all(masked_equal(g, (e,), (w,))
                  for g, e, w in zip(clean, want, widths)),
              f"{tier}: the fault-free dispatch is wrong")

        def faulty(model, queue):
            build.reset_launches()
            calls: list = []
            fdev = SimdramDevice(cfg=cfg, backend=tier, device=dev,
                                 fault=model)
            eng = getattr(fdev, tier)()
            eng._faulty_executor = _recording(eng._faulty_executor, calls)
            t0 = time.perf_counter()
            res = _flat(fdev.dispatch(queue))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(build.LAUNCHES)
            check(counts["faulty_replay"] == len(calls) > 0
                  and counts["replay"] == 0,
                  f"{tier}: {counts['faulty_replay']} K6 launches for "
                  f"{len(calls)} faulty runs (launches {counts})")
            for k, v in counts.items():
                total[k] += v
            return res, eng, calls, wall, counts

        model = FaultModel(sigma=0.15, spare_lanes=1, seed=0, max_retries=10)
        res, eng, calls, wall, counts = faulty(model, fmix)
        fs = eng.stats.faults
        n_wrong = sum(int((g.astype(np.int64) != e.astype(np.int64)).sum())
                      for g, e in zip(res, clean))
        check(n_wrong <= WRONG_LANE_SHARE * len(fmix) * FAULT_LANES,
              f"{tier}: {n_wrong} lanes differ from the fault-free dispatch")
        check(fs.injected > 0 and fs.detected > 0 and fs.corrected > 0,
              f"{tier}: faults were not injected, detected and corrected")
        # K6 on the first attempt against its plain version, timed beside
        # its bound; every other attempt of the three runs is held against
        # the plain version below, stacked by shape
        err0, plain0, k6_ms, k6_bound = _k6_attempt(dev, calls[0])
        prof = device_breakdown(lambda: SimdramDevice(
            cfg=cfg, backend=tier, device=dev, fault=model).dispatch(fmix))
        sigma = {"wall_s": wall, "wrong_lanes": n_wrong,
                 "k6_compared": len(calls),
                 "k6_launches": counts["faulty_replay"],
                 "k6_attempt_kernel_ms": k6_ms, "k6_bound_ms": k6_bound[0],
                 "k6_bound_by": k6_bound[1], "stats": fs.as_dict(),
                 "profiled": {k: prof[k] for k in (
                     "wall_ms", "device_busy_ms", "idle_share",
                     "device_ms")}}
        print(f"[7] faulty {tier} ({units} units), sigma 0.15, 1 spare lane, "
              f"{len(fmix)} x {FAULT_LANES} lanes: {n_wrong} lanes differ "
              f"from the fault-free dispatch, {wall:.3f} s host wall, "
              f"{counts['faulty_replay']} K6 launches (one per attempt); K6 "
              f"first attempt {k6_ms:.4f} ms (profiler), bound "
              f"{k6_bound[0]:.4f} ms ({k6_bound[1]}); FaultStats "
              f"{json.dumps(fs.as_dict())}")
        print(f"[7] faulty {tier} profiled: wall {prof['wall_ms']:.2f} ms, "
              f"card busy {prof['device_busy_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.4f}; device ms "
              f"{json.dumps(prof['device_ms'])}")

        # dead units: the first fault seed that draws one in some bank
        paths = ([(b,) for b in range(cfg.n_banks)] if tier == "chip" else
                 [(c, b) for c in range(n_chips) for b in range(cfg.n_banks)])
        seed = next(s for s in range(1000) if any(
            FaultRuntime(FaultModel(dead_unit_rate=0.1, seed=s), path,
                         cfg.subarrays_per_bank).dead.any() for path in paths))
        res_d, eng_d, calls_d, _, counts_d = faulty(FaultModel(
            p_flip=0.0, dead_unit_rate=0.1, spare_lanes=1, seed=seed), fmix)
        dfs = eng_d.stats.faults
        check(all(np.array_equal(g, e) for g, e in zip(res_d, clean)),
              f"{tier}: the dead-unit dispatch differs from the fault-free one")
        check(dfs.redispatches > 0 and dfs.remapped > 0,
              f"{tier}: dead units were not remapped: {dfs}")

        # sparse stuck columns, no flips: the vote outvotes each stuck
        # replica, so the run is exact
        smix = mix_queue(bank_mod, get_op, STUCK_LANES, n_instrs=2 * units)
        res_s, eng_s, calls_s, _, counts_s = faulty(FaultModel(
            p_flip=0.0, stuck_lane_rate=LADDER_STUCK_RATE, spare_lanes=2,
            seed=0), smix)
        sfs = eng_s.stats.faults
        swant = [o for ins in smix for o in get_op(ins.op, ins.n_bits).oracle(
            *ins.operands)]
        swidths = [w for ins in smix
                   for w in get_op(ins.op, ins.n_bits).out_bits]
        check(all(masked_equal(g, (e,), (w,))
                  for g, e, w in zip(res_s, swant, swidths)),
              f"{tier}: the stuck-only dispatch is not exact: {sfs}")
        check(sfs.detected > 0 and sfs.corrected > 0,
              f"{tier}: stuck columns were not detected and corrected: {sfs}")
        # every other attempt of the three runs through a bare K6 launch,
        # against the plain version stacked by state shape and flip rate
        errs_rest, plain_s = _k6_batched(dev, calls[1:] + calls_d + calls_s)
        errs = [err0] + errs_rest
        rows[f"faulty_{tier}"] = {
            "units": units, "sigma": sigma,
            "dead": {"seed": seed, "k6_launches": counts_d["faulty_replay"],
                     "k6_compared": len(calls_d), "stats": dfs.as_dict()},
            "stuck": {"rate": LADDER_STUCK_RATE,
                      "k6_launches": counts_s["faulty_replay"],
                      "k6_compared": len(calls_s), "stats": sfs.as_dict()}}
        k6_ladder[tier] = {
            "launches": (counts["faulty_replay"] + counts_d["faulty_replay"]
                         + counts_s["faulty_replay"]),
            "attempt_kernel_ms": k6_ms, "attempt_bound_ms": k6_bound[0],
            "first_attempt_plain_s": plain0, "group_plain_s": plain_s}
        _agree(agreement["faulty_replay"], f"faulty {tier}",
               k6_ladder[tier]["launches"], errs)
        print(f"[7] faulty {tier}: dead units (seed {seed}) exact after "
              f"blacklisting, {counts_d['faulty_replay']} K6 launches, "
              f"FaultStats {json.dumps(dfs.as_dict())}; stuck columns "
              f"{LADDER_STUCK_RATE:g}, 2 spare lanes, {len(smix)} x "
              f"{STUCK_LANES} lanes: exact, {counts_s['faulty_replay']} K6 "
              f"launches, FaultStats {json.dumps(sfs.as_dict())}")
        print(f"[7] faulty {tier}: K6 equals its plain version, states and "
              f"flip counts, on every attempt of the three runs "
              f"({len(calls)}, {len(calls_d)} and {len(calls_s)}; plain "
              f"{plain0:.1f} s for the first, then stacked by shape: "
              + fmt_list(plain_s) + " s)")

    kern["replay"]["ladder"] = k5_ladder
    kern["faulty_replay"]["ladder"] = k6_ladder
    record["ladder"] = rows
    return total


def app_runs(mode: str):
    """benchmarks/paper_tables.py:_app_runs, rebuilt on the port: the
    seven apps as device-taking callables at the "smoke" or "full"
    sizes.  The reference's full nn_layers call (32 x 32, 8 channels)
    raises its own range error at the default 16-bit width (its dense
    layer reaches -57,282, PERF.md); it runs here at 17 bits, the
    narrowest width that holds it."""
    from repro_torch.apps import (bitweaving, brightness, knn, lenet,
                                  nn_layers, tpch, vgg)
    if mode == "smoke":
        return [
            ("knn", lambda d: knn.run(n_points=256, n_features=4, n_bits=6,
                                      device=d)),
            ("tpch", lambda d: tpch.run(n_rows=512, device=d)),
            ("bitweaving", lambda d: bitweaving.run(n_rows=512, n_bits=8,
                                                    device=d)),
            ("brightness", lambda d: brightness.run(h=8, w=8, device=d)),
            ("nn_layers", lambda d: nn_layers.run(device=d)),
            ("lenet", lambda d: lenet.run(device=d, conv_channels=(2, 3),
                                          fc_dims=(12, 10))),
            ("vgg13", lambda d: vgg.run("vgg13", img_hw=8, n_layers=3,
                                        device=d)),
        ]
    return [
        ("knn", lambda d: knn.run(n_points=4096, n_features=16, device=d)),
        ("tpch", lambda d: tpch.run(n_rows=65536, device=d)),
        ("bitweaving", lambda d: bitweaving.run(n_rows=65536, device=d)),
        ("brightness", lambda d: brightness.run(h=128, w=128, device=d)),
        ("nn_layers", lambda d: nn_layers.run(img_hw=32, out_ch=8, n_bits=17,
                                              device=d)),
        ("lenet", lambda d: lenet.run(device=d)),
        ("vgg13", lambda d: vgg.run("vgg13", img_hw=32, device=d)),
    ]


def tpch_oracle(n_rows: int) -> int:
    """TPC-H Q6's revenue over the lineitem columns that
    src/repro_torch/apps/tpch.py draws at its default seed, in numpy."""
    rng = np.random.default_rng(0)
    shipdate = rng.integers(0, 2556, size=n_rows).astype(np.int64)
    quantity = rng.integers(1, 51, size=n_rows).astype(np.int64)
    discount = rng.integers(0, 11, size=n_rows).astype(np.int64)
    price = rng.integers(100, 10000, size=n_rows).astype(np.int64)
    sel = ((shipdate >= 365) & (shipdate < 730) & (discount >= 4)
           & (discount <= 6) & (quantity < 24))
    return int((price * discount)[sel].sum())


def _host(x):
    """Tensors, and those in a list, tuple or dict, copied to the host;
    other values as they are."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


class _Twins:
    """Within ``with``: each launch of K1, K2, K3, K5 and K6 made through
    the port's wrappers is followed by the kernel's plain version on the
    same inputs.  ``errs[kernel]`` gets the largest absolute difference of
    each launch (K6: of its states and its flip counts); with
    ``keep_rounds`` every K5 launch's (states, tables, schedule) is kept
    in ``rounds`` as well.  With ``host`` the plain version runs on host
    copies of the inputs: at narrow widths its loop over commands is
    bound by launches on the card, each a few microseconds of host work
    on the CPU."""

    def __init__(self, keep_rounds: bool = False, host: bool = False):
        self.errs = {"h2v": [], "v2h": [], "circuit": [], "replay": [],
                     "faulty_replay": []}
        self.rounds = []
        self.keep_rounds = keep_rounds
        self.host = host
        self._undo = []

    def __enter__(self):
        from repro_torch.core import control_unit as cu
        from repro_torch.kernels import bitplane_ops, build
        from repro_torch.kernels import transpose_kernel as tk

        def twin(name, orig, plain):
            def wrapped(*args, **kw):
                before = build.LAUNCHES[name]
                out = orig(*args, **kw)
                if build.LAUNCHES[name] > before:
                    got = _host(out) if self.host else out
                    want = (plain(*_host(args), **_host(kw)) if self.host
                            else plain(*args, **kw))
                    pairs = (zip(got, want) if isinstance(got, tuple)
                             else [(got, want)])
                    self.errs[name].append(max(max_abs_err(o, w)
                                               for o, w in pairs))
                    if name == "replay" and self.keep_rounds:
                        self.rounds.append(args)
                return out
            return wrapped

        for name, orig, plain in (
                ("h2v", tk.h2v_cuda, tk.h2v_plain),
                ("v2h", tk.v2h_cuda, tk.v2h_plain),
                ("circuit", bitplane_ops._circuit_kernel,
                 bitplane_ops.circuit_plain),
                ("replay", cu._replay_kernel,
                 lambda states, tables, schedule: cu.replay_plain(
                     states, tables)),
                ("faulty_replay", cu._faulty_replay_kernel,
                 lambda states, tables, schedule, keys, s0, s1, dead, thr:
                 cu.faulty_replay_plain(states, tables, keys, s0, s1, dead,
                                        thr / 2 ** 32))):
            wrapped = twin(name, orig, plain)
            for mod_name, mod in list(sys.modules.items()):
                if not mod_name.startswith("repro_torch") or mod is None:
                    continue
                for attr, val in list(vars(mod).items()):
                    if val is orig:
                        setattr(mod, attr, wrapped)
                        self._undo.append((mod, attr, orig))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()


def _app_once(fn, backend: str, cfg, device: str):
    """One run of an app on a fresh ``SimdramDevice``: (result, device,
    host wall s)."""
    import torch

    from repro_torch.core.isa import SimdramDevice
    d = SimdramDevice(backend=backend, cfg=cfg, device=device)
    t0 = time.perf_counter()
    r = fn(d)
    if device == "cuda":
        torch.cuda.synchronize()
    return r, d, time.perf_counter() - t0


def _same_output(a: dict, b: dict) -> bool:
    return np.array_equal(np.asarray(a["output"]).astype(np.int64),
                          np.asarray(b["output"]).astype(np.int64))


def _same_result(a: dict, b: dict) -> bool:
    """Two result dicts ``==``: the outputs as int64 arrays, every other
    key (the device's totals among them) as plain values."""
    return _same_output(a, b) and (
        {k: v for k, v in a.items() if k != "output"}
        == {k: v for k, v in b.items() if k != "output"})


def _modeled(d):
    """The engine's stats without the measured wall clocks (None for the
    sequential rungs)."""
    from repro_torch.apps.runtime import engine_stats
    es = engine_stats(d)
    return None if es is None else {k: v for k, v in es.items()
                                    if k not in MEASURED_STATS}


def _bench_mismatches(tier: dict, d) -> tuple:
    """A rung of BENCH_apps.json against a live run's device ``d``: the
    fields that differ beyond BENCH_REL_TOL (an integer or a flag must be
    equal), how many float fields differ at all, and how many fields were
    compared."""
    from repro_torch.apps.runtime import engine_stats
    t = d.totals()
    pairs = [("device_latency_s", tier["modeled"]["device_latency_s"],
              t["latency_s"]),
             ("device_energy_mj", tier["modeled"]["device_energy_mj"],
              t["energy_mj"])]
    want, got = tier["modeled"]["engine"], engine_stats(d)
    if (want is None) != (got is None):
        return [("engine", want, got)], 0, 1
    for k, v in (want or {}).items():
        if k not in MEASURED_STATS:
            pairs.append((k, v, got.get(k)))
    bad, n_float_diff = [], 0
    for k, w, g in pairs:
        if isinstance(w, float) and isinstance(g, float):
            n_float_diff += w != g
            if abs(w - g) > BENCH_REL_TOL * max(abs(w), abs(g)):
                bad.append((k, w, g))
        elif type(w) is not type(g) or w != g:
            bad.append((k, w, g))
    return bad, n_float_diff, len(pairs)


def _app_path(fn, backend: str, cfg, total: dict, errs: dict,
              warm: bool = True, keep_rounds: bool = False):
    """One app on one rung of the card: the counted run (launch counters
    0 just before, read just after), then its twin (a repeat in which
    every launch is held against its plain version and must agree bit
    for bit; one twin per launch of the counted run) and, with ``warm``,
    a timed warm repeat.  Adds the counts to ``total`` and the twins'
    errors to ``errs``; returns (row, result, device, twins)."""
    from repro_torch.core.control_unit import TABLE_CACHE
    from repro_torch.kernels import build

    build.reset_launches()
    c0 = TABLE_CACHE.stats()
    r, d, first_s = _app_once(fn, backend, cfg, "cuda")
    counts = dict(build.LAUNCHES)
    c1 = TABLE_CACHE.stats()
    check(r["verified"] is True, f"{backend}: the app did not verify")
    stats = d.totals()
    eng = _modeled(d)
    pack_s = (None if eng is None else
              getattr(d, backend)().stats.pack_wall_s)
    if backend == "bitplane":
        want = {"circuit"}
    elif backend == "cuda":
        want = {"h2v", "v2h", "circuit"}
    else:
        want = {"replay"}
        rounds = eng.get("rounds", eng.get("super_rounds", eng["batches"]))
        check(counts["replay"] == rounds, f"{backend}: {counts['replay']} K5 "
              f"launches for {rounds} rounds")
    check(all(counts[k] > 0 for k in want)
          and all(v == 0 for k, v in counts.items() if k not in want),
          f"{backend}: launches {counts}, expected only {sorted(want)}")
    for k, v in counts.items():
        total[k] += v

    with _Twins(keep_rounds) as tw:
        r_t, _, _ = _app_once(fn, backend, cfg, "cuda")
    for k in errs:
        e = tw.errs[k]
        check(len(e) == counts[k], f"{backend}: {len(e)} {k} launches in "
              f"the twin run, {counts[k]} in the counted run")
        check(max(e, default=0) == 0, f"{backend}: {k} disagrees with its "
              f"plain version: {max(e, default=0)}")
        errs[k] += e
    check(_same_result(r_t, r), f"{backend}: the twin run's result differs")

    row = {"first_wall_s": first_s, "first_pack_wall_s": pack_s,
           "launches": {k: counts[k] for k in ("h2v", "v2h", "circuit",
                                               "replay")},
           "rounds": counts["replay"] if backend in FUSED_RUNGS else None,
           "table_cache_first": {k: c1[k] - c0[k]
                                 for k in ("hits", "misses", "evictions")},
           "latency_s": stats["latency_s"], "energy_mj": stats["energy_mj"]}
    if warm:
        cw = TABLE_CACHE.stats()
        before = dict(build.LAUNCHES)
        r_w, d_w, warm_s = _app_once(fn, backend, cfg, "cuda")
        c2 = TABLE_CACHE.stats()
        check(all(build.LAUNCHES[k] - before[k] == counts[k]
                  for k in counts) and _same_result(r_w, r),
              f"{backend}: the warm run differs from the counted run")
        row.update({
            "warm_wall_s": warm_s,
            "warm_pack_wall_s": (None if eng is None else getattr(
                d_w, backend)().stats.pack_wall_s),
            "table_cache_warm": {k: c2[k] - cw[k]
                                 for k in ("hits", "misses", "evictions")},
            "table_cache_bytes": c2["bytes"],
            "table_cache_entries": c2["entries"]})
    return row, r, d, tw


def _fmt_app_row(name: str, backend: str, row: dict) -> str:
    pack = ("" if row["first_pack_wall_s"] is None else
            f" (pack {row['first_pack_wall_s']:.3f} s)")
    warm = ""
    if "warm_wall_s" in row:
        wp = ("" if row["warm_pack_wall_s"] is None else
              f" (pack {row['warm_pack_wall_s']:.3f} s)")
        warm = (f", warm {row['warm_wall_s']:.3f} s{wp}, cache warm "
                f"{row['table_cache_warm']}")
    rounds = "" if row["rounds"] is None else f", {row['rounds']} rounds"
    return (f"{name}/{backend}: first {row['first_wall_s']:.3f} s{pack}"
            f"{warm}; launches K1 {row['launches']['h2v']}, K2 "
            f"{row['launches']['v2h']}, K3 {row['launches']['circuit']}, "
            f"K5 {row['launches']['replay']}{rounds}; cache first "
            f"{row['table_cache_first']}; modeled latency "
            f"{row['latency_s']!r} s, energy {row['energy_mj']!r} mJ")


def apps_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 8: the seven apps on the card's five rungs.  8a at the
    reference's recorded sizes against the CPU and BENCH_apps.json, 8b at
    the full sizes, 8c TPC-H Q6 at scale factor 1.  Every launch has its
    twin through the plain version (the ``apps`` path of each kernel's
    agreement); returns the launch counts of the counted runs, summed."""
    import torch

    from repro_torch.apps.runtime import n_parallel_units, shard_slices
    from repro_torch.core.control_unit import TABLE_CACHE
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.timing import DramConfig
    from repro_torch.kernels import build

    total = {k: 0 for k in build.LAUNCHES}
    errs = {"h2v": [], "v2h": [], "circuit": [], "replay": []}
    out = record["apps"] = {"smoke": {}, "full": {}, "sf1": {}}

    # -- 8a: the reference's recorded sizes -------------------------------
    bench = json.loads((ROOT / "BENCH_apps.json").read_text())
    check(bench["config"]["mode"] == "smoke" and all(
        bench["config"][k] == v for k, v in APPS_SMOKE_CFG.items()),
        f"BENCH_apps.json records another configuration: {bench['config']}")
    cfg = DramConfig(**APPS_SMOKE_CFG)
    t0 = time.perf_counter()
    n_float_diff = n_fields = 0
    for name, fn in app_runs("smoke"):
        results = {}
        for be in APP_RUNGS:
            row, r, d, _ = _app_path(fn, be, cfg, total, errs, warm=False)
            results[be] = r
            if be == "cuda":
                check(_same_output(r, results["bitplane"]),
                      f"8a {name}: the cuda rung's output differs from the "
                      f"bitplane rung's")
                continue
            r_c, d_c, _ = _app_once(fn, be, cfg, "cpu")
            check(_same_result(r, r_c) and d.totals() == d_c.totals()
                  and _modeled(d) == _modeled(d_c),
                  f"8a {name}/{be}: the card's run differs from the CPU's")
            tier = bench["apps"][name]["tiers"][be]
            check(tier["verified"] is True, f"8a {name}/{be}: not verified "
                  f"in BENCH_apps.json")
            bad, n_diff, n = _bench_mismatches(tier, d)
            check(not bad, f"8a {name}/{be} differs from BENCH_apps.json: "
                  f"{bad}")
            n_float_diff += n_diff
            n_fields += n
            out["smoke"][f"{name}/{be}"] = row
    print(f"[8a] 7 apps x {len(APP_RUNGS)} rungs at the smoke sizes on "
          f"{APPS_SMOKE_CFG}: card == CPU (outputs, result dicts, totals, "
          f"modeled engine stats); == BENCH_apps.json on every integer "
          f"field, floats within {BENCH_REL_TOL:g} relative "
          f"({n_float_diff} of {n_fields} fields differ in the last bits); "
          f"cuda == bitplane; {time.perf_counter() - t0:.1f} s")

    # -- 8b: the reference's full sizes -----------------------------------
    cfg = DramConfig(**APPS_FULL_CFG)
    t0 = time.perf_counter()
    for name, fn in app_runs("full"):
        results = {}
        for be in APP_RUNGS:
            row, r, d, _ = _app_path(fn, be, cfg, total, errs)
            results[be] = r
            out["full"][f"{name}/{be}"] = row
            print(f"[8b] {_fmt_app_row(name, be, row)}", flush=True)
        check(all(_same_output(r, results["bitplane"])
                  for r in results.values()),
              f"8b {name}: the outputs differ across the rungs")
    print(f"[8b] 7 apps at the full sizes on {APPS_FULL_CFG}: verified and "
          f"bit-equal on all {len(APP_RUNGS)} rungs; "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 8c: TPC-H Q6 at scale factor 1 -----------------------------------
    from repro_torch.apps import tpch
    want = tpch_oracle(TPCH_SF1_ROWS)
    fn = lambda d: tpch.run(n_rows=TPCH_SF1_ROWS, device=d)  # noqa: E731
    shards = shard_slices(TPCH_SF1_ROWS, n_parallel_units(
        SimdramDevice(backend="channel", cfg=cfg, device=dev)))
    t0 = time.perf_counter()
    for be in APP_RUNGS:
        fused = be in FUSED_RUNGS
        row, r, d, tw = _app_path(fn, be, cfg, total, errs,
                                  keep_rounds=fused)
        check(r["revenue"] == want, f"8c {be}: revenue {r['revenue']} != "
              f"{want}")
        row["revenue"] = r["revenue"]
        if fused:
            prof = device_breakdown(lambda: _app_once(fn, be, cfg, "cuda"))
            row["profiled"] = {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "idle_share", "device_ms")}
            row["h2d_ms"] = sum(v for k, v in prof["device_ms"].items()
                                if "HtoD" in k)
            row["k5_device_ms"] = sum(v for k, v in prof["device_ms"].items()
                                      if "replay_kernel" in k)
            note_profiled(f"8c {be}", "replay_kernel", prof)
            per_round = []
            for states, tables, schedule in tw.rounds:
                ms, (b_ms, b_by) = _k5_round_ms(states, tables, schedule, 10,
                                                profiler=False)
                per_round.append({"device_ms": ms, "bound_ms": b_ms,
                                  "bound_by": b_by,
                                  "shape": list(states.shape),
                                  "cmds": int(tables.shape[-2])})
            row["k5_rounds"] = per_round
        del tw
        out["sf1"][be] = row
        print(f"[8c] {_fmt_app_row('tpch_sf1', be, row)}; revenue "
              f"{r['revenue']} == numpy", flush=True)
        if fused:
            print(f"[8c] tpch_sf1/{be} profiled: wall "
                  f"{row['profiled']['wall_ms']:.1f} ms, card busy "
                  f"{row['profiled']['device_busy_ms']:.3f} ms, idle share "
                  f"{row['profiled']['idle_share']:.4f}, host-to-device "
                  f"copies {row['h2d_ms']:.3f} ms, K5 "
                  f"{row['k5_device_ms']:.3f} ms; device ms "
                  f"{json.dumps(row['profiled']['device_ms'])}")
            print(f"[8c] tpch_sf1/{be} K5 per round (CUDA events over 10 "
                  f"bare launches): " + ", ".join(
                f"{x['device_ms']:.4f} ms ({'x'.join(map(str, x['shape']))}"
                f", {x['cmds']} cmds; bound {x['bound_ms']:.4f} "
                f"{x['bound_by']})" for x in row["k5_rounds"]))
        del r, d
        torch.cuda.empty_cache()
    cache = TABLE_CACHE.stats()
    print(f"[8c] TPC-H Q6 over {TPCH_SF1_ROWS} rows ({len(shards)} channel "
          f"shards of up to {shards[0].stop} rows): revenue {want} on all "
          f"{len(APP_RUNGS)} rungs; table cache {cache}; "
          f"{time.perf_counter() - t0:.1f} s")

    for name, e in errs.items():
        agreement = kern[name].setdefault("agreement", {})
        _agree(agreement, "apps", total[name], e)
    print(f"[8] apps path: launches {total}; every launch's twin agrees "
          f"with the plain version bit for bit ({sum(map(len, errs.values()))}"
          f" compared)")
    return total


# -- phase 9: the serving front-end -------------------------------------------

def serve_traffic(get_op, n_windows: int, lanes: int, seed: int = 0):
    """benchmarks/serving_soak.py:_traffic, window by window: each window
    ``SERVE_WINDOW`` (op, n_bits, operands) requests of ``lanes`` lanes,
    ops from ``SERVE_OPS`` at 8 or 16 bits, one numpy stream."""
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(n_windows):
        reqs = []
        for _ in range(SERVE_WINDOW):
            op = SERVE_OPS[int(rng.integers(len(SERVE_OPS)))]
            n_bits = (8, 16)[int(rng.integers(2))]
            operands = tuple(
                np.asarray(rng.integers(0, 1 << min(n_bits, 16),
                                        size=lanes), np.int64)
                for _ in range(get_op(op, n_bits).n_operands))
            reqs.append((op, n_bits, operands))
        windows.append(reqs)
    return windows


def serve_frontend(engine, **kw):
    """The soak's frontend over ``engine`` (serving_soak.py:96): a queue
    of three quarters of a window, so every window overflows, two
    retries, seed 0."""
    from repro_torch.core.telemetry import REGISTRY
    from repro_torch.serving import ServingFrontend
    REGISTRY.reset()
    args = dict(max_queue_depth=SERVE_DEPTH, window=SERVE_WINDOW,
                max_retries=2, seed=0)
    args.update(kw)
    return ServingFrontend(engine, **args)


def serve_windows(fe, windows, sync=lambda: None, worker: bool = False,
                  submitter=None):
    """Submit and resolve each window as serving_soak._soak_scenario
    does: tenants in turn, every fourth request with the tight deadline,
    every fifth at priority 1, the overflow rejected at admission; then
    ``drain()``, or with ``worker`` the pump on its background thread
    started and stopped around the window.  Returns the tickets and, per
    window, the host wall, packing wall, K5 launches and the engine's
    super-rounds."""
    from repro_torch.kernels import build
    from repro_torch.serving import AdmissionRejected, DeadlineExceeded
    tickets, per = [], []
    for reqs in windows:
        mine = []
        for i, (op, n_bits, operands) in enumerate(reqs):
            deadline = fe.now_s + (SERVE_TIGHT_S if i % 4 == 3
                                   else SERVE_GENEROUS_S)
            try:
                t = fe.submit(SERVE_TENANTS[i % len(SERVE_TENANTS)], op,
                              operands, n_bits, deadline_s=deadline,
                              priority=1 if i % 5 == 0 else 0)
            except AdmissionRejected:
                continue
            mine.append((t, op, n_bits, operands))
        st = fe.engine.stats
        k5, rounds = build.LAUNCHES["replay"], st.super_rounds
        pack = st.pack_wall_s
        t0 = time.perf_counter()
        if worker:
            fe.start()
            try:
                for t, *_ in mine:
                    try:
                        t.result(timeout=600)
                    except DeadlineExceeded:
                        pass
            finally:
                fe.stop()
        else:
            fe.drain()
        sync()
        per.append({"wall_s": time.perf_counter() - t0,
                    "pack_wall_s": st.pack_wall_s - pack,
                    "k5_launches": build.LAUNCHES["replay"] - k5,
                    "super_rounds": st.super_rounds - rounds,
                    "admitted": len(mine)})
        tickets += mine
    return tickets, per


def serve_check(fe, tickets, wrong_lane_share: float = 0.0) -> int:
    """The soak's invariants: zero lost and zero duplicated tickets (a
    second resolution raises inside the frontend), the ticket accounting
    closes, and every completed ticket equals ``bbop_host_oracle`` —
    up to ``wrong_lane_share`` of the lanes where the fault layer's vote
    may accept replicas corrupted alike.  Returns the wrong lanes."""
    from repro_torch.serving import DeadlineExceeded
    from repro_torch.train.serve import bbop_host_oracle
    ok = missed = wrong = lanes = 0
    for t, op, n_bits, operands in tickets:
        check(t.done, f"ticket {t.seq} was lost")
        try:
            got = t.result(timeout=0)
        except DeadlineExceeded:
            missed += 1
            continue
        want = bbop_host_oracle(op, n_bits, operands)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        wrong += sum(int((np.asarray(g) != np.asarray(w)).sum())
                     for g, w in zip(got, want))
        lanes += operands[0].shape[-1]
        ok += 1
    s = fe.stats
    check(s.admitted == len(tickets) and ok == s.completed
          and missed == s.deadline_missed
          and s.completed + s.deadline_missed == s.admitted,
          f"ticket accounting does not close: {s.as_dict()}, {ok} ok, "
          f"{missed} missed, {len(tickets)} tickets")
    check(wrong <= wrong_lane_share * lanes,
          f"{wrong} of {lanes} completed lanes differ from the host oracle")
    return wrong


def serve_digest(fe, tickets) -> dict:
    """What two runs of the same traffic must share: the frontend's
    stats, each ticket's value (a hash of its int64 outputs, or where its
    deadline was missed), tenant, fallback and ``resolved_s``, and the
    ``serving.*`` registry; as JSON, so floats compare exactly."""
    import hashlib

    from repro_torch.core.telemetry import REGISTRY
    from repro_torch.serving import DeadlineExceeded
    rows = []
    for t, *_ in tickets:
        try:
            v = t.result(timeout=0)
            h = hashlib.sha256()
            for x in (v if isinstance(v, tuple) else (v,)):
                h.update(np.ascontiguousarray(x, np.int64).tobytes())
            value = h.hexdigest()
        except DeadlineExceeded as e:
            value = f"deadline missed {e.where}"
        rows.append([t.seq, t.tenant, t.via_host, value, t.resolved_s])
    return json.loads(json.dumps({
        "stats": fe.stats.as_dict(), "tickets": rows,
        "registry": REGISTRY.snapshot("serving.")}))


def serve_latency(fe) -> dict:
    """Modeled p50 and p99 latency and goodput, as the soak reports them."""
    from repro_torch.core.telemetry import REGISTRY
    hist = REGISTRY.histogram("serving.latency_modeled_s")
    return {"p50_latency_s": hist.percentile(50),
            "p99_latency_s": hist.percentile(99),
            "goodput_rps": fe.stats.completed / max(fe.now_s, 1e-12),
            "modeled_duration_s": fe.now_s}


def serve_channel(device, fault=None, n_chips: int = SERVE_CHIPS):
    """Phase 7's channel at full width: ``n_chips`` chips of 16 banks of
    one compute subarray (65,536 columns each)."""
    from repro_torch.core.channel import SimdramChannel
    from repro_torch.core.timing import DDR4
    return SimdramChannel(n_chips=n_chips, n_banks=DDR4.n_banks,
                          n_subarrays=DDR4.subarrays_per_bank, cfg=DDR4,
                          fault=fault, device=device)


def _traced_profiled(fn, reset, span: str):
    """``fn()`` under a tracer and ``torch.profiler`` at once, up to
    TRACED_PROFILER_ATTEMPTS sessions (``reset()`` before each): for each
    ``span`` span, its ``device_s`` and the profiler's time of its K5
    launch, in ms, from the first session that recorded that launch.  A
    traced launch comes right behind its start event's spin kernel
    (``telemetry.LAUNCH_GATE_CYCLES``), which tells the launches apart
    where the profiler dropped one (it does now and then).  Returns
    ``{round: (device ms, profiler ms)}``, the rounds, and what each
    session recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    pairs, seen, n = {}, [], 0
    for _ in range(TRACED_PROFILER_ATTEMPTS):
        reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with obs.enabled() as tr:
                fn()
            torch.cuda.synchronize()
        dev_ms = [s.attrs["device_s"] * 1e3 for r in tr.roots
                  for s in r.walk() if s.name == span]
        n = len(dev_ms)
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "Memcpy" not in e.name),
                     key=lambda e: e.time_range.start)
        names = [kernel_name(e.name) for e in evs]
        spins = [j for j, name in enumerate(names)
                 if name.endswith("spin_kernel")]
        k5 = sum(1 for name in names if name == "replay_kernel")
        seen.append(f"{len(spins)} gates and {k5} K5 of {n}")
        if len(spins) != n:
            continue
        for i, j in enumerate(spins):
            if (i not in pairs and j + 1 < len(evs)
                    and names[j + 1] == "replay_kernel"):
                pairs[i] = (dev_ms[i], evs[j + 1].time_range.elapsed_us()
                            / 1e3)
        if len(pairs) == n:
            break
    return pairs, n, seen


def serving_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 9: the multi-tenant server on the card.  9a the soak's
    traffic over phase 7's full-width channel, against the oracle, a CPU
    run and its worker-thread mode; 9b a sigma 0.15 window on the 2-chip
    faulty channel and the soak's breaker scenario; 9c one traced
    full-width dispatch against an untraced one.  Every K5 and K6 launch
    of 9a and 9b has its twin through the plain version; returns their
    launch counts, summed."""
    import threading

    import torch

    from repro_torch import obs
    from repro_torch.core import bank as bank_mod
    from repro_torch.core.fault import FaultModel
    from repro_torch.core.ops_library import get_op
    from repro_torch.core.telemetry import REGISTRY
    from repro_torch.core.timing import DDR4
    from repro_torch.kernels import build

    card = record["card"]
    out = record["serving"] = {}
    total = {k: 0 for k in build.LAUNCHES}
    t_phase = time.perf_counter()
    lanes = DDR4.columns_per_subarray
    windows = serve_traffic(get_op, SERVE_WINDOWS, lanes)
    sync = torch.cuda.synchronize

    # -- 9a: the server at full width -------------------------------------
    engine = serve_channel(dev)
    fe = serve_frontend(engine)
    build.reset_launches()
    tickets, first = serve_windows(fe, windows, sync)
    counts = dict(build.LAUNCHES)
    for w in first:
        check(w["k5_launches"] == w["super_rounds"] > 0,
              f"9a: {w['k5_launches']} K5 launches for {w['super_rounds']} "
              f"super-rounds in a window")
    check(counts["replay"] > 0 and counts["faulty_replay"] == 0
          and counts["h2v"] == counts["v2h"] == counts["circuit"] == 0,
          f"9a: unexpected launches {counts}")
    serve_check(fe, tickets)
    digest = serve_digest(fe, tickets)
    latency = serve_latency(fe)
    for k, v in counts.items():
        total[k] += v

    # the warm repeat (the same placement: lane loads reset), each
    # round's inputs kept for its twin; then the same traffic under the
    # profiler, and through the worker thread with a tracer on
    engine.reset_stats()
    rounds: list = []
    executor = engine.executor
    engine.executor = _recording(executor, rounds)
    fe = serve_frontend(engine)
    tickets_w, warm = serve_windows(fe, windows, sync)
    engine.executor = executor
    check(serve_digest(fe, tickets_w) == digest,
          "9a: the warm repeat resolved other tickets or values")
    check(len(rounds) == counts["replay"],
          f"9a: the repeat ran {len(rounds)} rounds, the counted run "
          f"{counts['replay']}")
    del tickets_w
    engine.reset_stats()
    fe = serve_frontend(engine)
    prof = device_breakdown(lambda: serve_windows(fe, windows, sync))
    note_profiled("9a", "replay_kernel", prof)
    h2d_ms = sum(v for k, v in prof["device_ms"].items() if "HtoD" in k)

    engine.reset_stats()
    main_stream = torch.cuda.current_stream().cuda_stream
    seen = []
    dispatch = engine.dispatch

    def watched(queue, cancel=None):
        seen.append((threading.get_ident(),
                     torch.cuda.current_stream().cuda_stream))
        return dispatch(queue, cancel=cancel)

    engine.dispatch = watched
    fe = serve_frontend(engine)
    with obs.enabled(max_dispatches=256) as tr:
        tickets_t, _ = serve_windows(fe, windows, sync, worker=True)
    del engine.dispatch
    check(serve_digest(fe, tickets_t) == digest,
          "9a: the worker thread resolved other tickets or values")
    check(seen and all(t != threading.get_ident() and s == main_stream
                       for t, s in seen),
          f"9a: the worker dispatched on another stream or thread: {seen}")
    replay_spans = [s for r in tr.roots for s in r.walk()
                    if s.name == "channel.replay"]
    check(len(replay_spans) == counts["replay"] and all(
        "device_s" in s.attrs for s in replay_spans),
        f"9a: {len(replay_spans)} channel.replay spans of the worker's run "
        f"for {counts['replay']} K5 launches, or one has no device_s")
    check(tr.depth == 0, "9a: the worker left spans open")
    del tickets_t

    # K5 on every round of the repeat against the plain replay
    per_round = []
    for states_np, ct in rounds:
        ms, bnd, err, plain_s, states = _round_k5(dev, states_np, ct)
        per_round.append({"kernel_ms": ms, "bound_ms": bnd[0],
                          "bound_by": bnd[1], "max_abs_err": err,
                          "plain_s": plain_s,
                          "units": int(states.shape[0]),
                          "rows": int(states.shape[1]),
                          "words": int(states.shape[2]),
                          "cmds": int(ct.tables.shape[1])})
        del states
    del rounds
    torch.cuda.empty_cache()

    # the same traffic on the CPU
    t_cpu = time.perf_counter()
    cpu_engine = serve_channel("cpu")
    fe_cpu = serve_frontend(cpu_engine)
    tickets_c, _ = serve_windows(fe_cpu, windows)
    cpu_s = time.perf_counter() - t_cpu
    check(serve_digest(fe_cpu, tickets_c) == digest,
          "9a: the card's run differs from the CPU run")
    del tickets_c, cpu_engine, fe_cpu
    i = 0
    for w, wr in zip(first, warm):
        rs = per_round[i:i + w["super_rounds"]]
        i += w["super_rounds"]
        w.update({"warm_wall_s": wr["wall_s"],
                  "warm_pack_wall_s": wr["pack_wall_s"],
                  "k5_kernel_ms": [r["kernel_ms"] for r in rs],
                  "k5_bound_ms": [r["bound_ms"] for r in rs],
                  "k5_words": [r["words"] for r in rs]})
    out["9a"] = {"windows": first, "launches": counts, "latency": latency,
                 "stats": digest["stats"], "registry": digest["registry"],
                 "profiled": {k: prof[k] for k in (
                     "wall_ms", "device_busy_ms", "idle_share",
                     "device_ms")},
                 "h2d_ms": h2d_ms, "rounds": per_round, "cpu_run_s": cpu_s,
                 "worker_stream": main_stream}
    for n, w in enumerate(first):
        print(f"[9a] window {n}: {w['admitted']} admitted, first "
              f"{w['wall_s']:.3f} s (pack {w['pack_wall_s']:.3f}), warm "
              f"{w['warm_wall_s']:.3f} s (pack {w['warm_pack_wall_s']:.3f}), "
              f"{w['k5_launches']} K5 launches, K5 "
              + ", ".join(f"{m:.4f} ms (bound {b:.4f}, {x} words)"
                          for m, b, x in zip(w["k5_kernel_ms"],
                                             w["k5_bound_ms"],
                                             w["k5_words"]))
              + f"; {card}", flush=True)
    print(f"[9a] server over {SERVE_CHIPS} x {DDR4.n_banks} units, "
          f"{SERVE_WINDOWS} windows of {SERVE_WINDOW} requests x {lanes} "
          f"lanes: stats {json.dumps(digest['stats'])}; modeled p50 "
          f"{latency['p50_latency_s']:.6e} s, p99 "
          f"{latency['p99_latency_s']:.6e} s, goodput "
          f"{latency['goodput_rps']:.1f} requests/s; every completed "
          f"ticket == the host oracle; card == CPU run ({cpu_s:.1f} s) on "
          f"stats, tickets, resolved_s and registry; worker thread equal, "
          f"on the main thread's stream; {card}")
    print(f"[9a] profiled traffic: wall {prof['wall_ms']:.1f} ms, card busy "
          f"{prof['device_busy_ms']:.3f} ms, idle share "
          f"{prof['idle_share']:.4f}, host-to-device copies {h2d_ms:.3f} ms; "
          f"device ms {json.dumps(prof['device_ms'])}; {card}")
    print(f"[9a] K5 equals the plain replay bit for bit on all "
          f"{len(per_round)} rounds (plain " + ", ".join(
              f"{r['plain_s']:.2f}" for r in per_round) + " s)", flush=True)

    # -- 9b: faults ---------------------------------------------------------
    def faulty_window(engine, fe, wins):
        calls: list = []
        engine._faulty_executor = _recording(engine._faulty_executor, calls)
        build.reset_launches()
        t0 = time.perf_counter()
        tks, per = serve_windows(fe, wins, sync)
        wall = time.perf_counter() - t0
        c = dict(build.LAUNCHES)
        check(c["faulty_replay"] == len(calls) > 0 and c["replay"] == 0,
              f"9b: {c['faulty_replay']} K6 launches for {len(calls)} "
              f"faulty runs (launches {c})")
        for k, v in c.items():
            total[k] += v
        return tks, calls, wall, c

    # the soak's faulty model (serving_soak.py:93)
    sigma_model = FaultModel(sigma=0.15, spare_lanes=1,
                             stuck_lane_rate=0.002, seed=21)
    f_engine = serve_channel(dev, fault=sigma_model, n_chips=2)
    fe = serve_frontend(f_engine)
    f_windows = serve_traffic(get_op, 1, SERVE_FAULT_LANES)
    tks, calls, wall, c_sigma = faulty_window(f_engine, fe, f_windows)
    wrong = serve_check(fe, tks, WRONG_LANE_SHARE)
    _, _, k6_ms, k6_bound = _k6_attempt(dev, calls[0])
    sigma_calls = calls
    sigma = {"wall_s": wall, "wrong_lanes": wrong,
             "k6_launches": c_sigma["faulty_replay"],
             "k6_attempt_kernel_ms": k6_ms, "k6_bound_ms": k6_bound[0],
             "frontend": fe.stats.as_dict(),
             "faults": f_engine.stats.faults.as_dict()}
    print(f"[9b] sigma 0.15 window on {2 * DDR4.n_banks} units, "
          f"{len(tks)} admitted of {SERVE_WINDOW} x {SERVE_FAULT_LANES} "
          f"lanes: "
          f"{wrong} completed lanes differ from the oracle, {wall:.3f} s "
          f"host wall, {c_sigma['faulty_replay']} K6 launches (one per "
          f"attempt); K6 first attempt {k6_ms:.4f} ms (bound "
          f"{k6_bound[0]:.4f}); frontend {json.dumps(sigma['frontend'])}; "
          f"FaultStats {json.dumps(sigma['faults'])}; {card}", flush=True)
    del tks

    # the soak's breaker scenario (serving_soak.py:169)
    bench = json.loads((ROOT / "BENCH_serving.json").read_text())
    b_model = FaultModel(p_flip=0.0, dead_unit_rate=0.3, spare_lanes=1,
                         max_redispatches=0, seed=0)
    from repro_torch.core.channel import SimdramChannel
    b_engine = SimdramChannel(n_chips=1, n_banks=2, n_subarrays=2,
                              fault=b_model, device=dev)
    fe = serve_frontend(b_engine, max_retries=0, breaker_threshold=1,
                        breaker_cooldown_s=1e-5, window=8,
                        max_queue_depth=256)
    rng = np.random.default_rng(7)
    b_windows = []
    for _ in range(3):
        b_windows.append([
            (op, 8, (np.asarray(rng.integers(0, 256, 64), np.int64),
                     np.asarray(rng.integers(0, 256, 64), np.int64)))
            for op in ("addition", "subtraction", "min", "max")])
    calls: list = []
    b_engine._faulty_executor = _recording(b_engine._faulty_executor, calls)
    build.reset_launches()
    b_tickets = []
    for n, win in enumerate(b_windows):
        if n == 2:
            fe.now_s += 10 * fe.breaker_cooldown_s     # cooldown elapses
        for op, n_bits, operands in win:
            b_tickets.append((fe.submit("alice", op, operands, n_bits), op,
                              n_bits, operands))
        fe.drain()
    c_b = dict(build.LAUNCHES)
    check(c_b["faulty_replay"] == len(calls) > 0 and c_b["replay"] == 0,
          f"9b breaker: {c_b['faulty_replay']} K6 launches for "
          f"{len(calls)} faulty runs")
    for k, v in c_b.items():
        total[k] += v
    serve_check(fe, b_tickets)
    via = [t.via_host for t, *_ in b_tickets]
    check(all(via[:8]) and not any(via[8:]),
          f"9b breaker: trip and shed to the host, then recover on the "
          f"card, expected; got via_host {via}")
    s = fe.stats
    block = {k: int(getattr(s, k)) for k in (
        "breaker_trips", "breaker_recoveries", "host_fallbacks",
        "completed")}
    check(block == {k: bench["breaker"][k] for k in block},
          f"9b breaker: {block} != BENCH_serving.json {bench['breaker']}")
    reg = REGISTRY.snapshot("serving.")
    check(set(reg) == set(bench["registry"]) and all(
        reg[k] == v if isinstance(v, int) else
        abs(reg[k] - v) <= BENCH_REL_TOL * abs(v)
        for k, v in bench["registry"].items()),
        f"9b breaker: registry {reg} != BENCH_serving.json "
        f"{bench['registry']}")
    errs6, plain6 = _k6_batched(dev, sigma_calls + calls)
    _agree(kern["faulty_replay"]["agreement"], "serving faults",
           c_sigma["faulty_replay"] + c_b["faulty_replay"], errs6)
    out["9b"] = {"sigma": sigma, "breaker": {
        **block, "k6_launches": c_b["faulty_replay"], "registry": reg},
        "k6_plain_s": plain6}
    print(f"[9b] breaker (1 chip x 2 banks x 2 subarrays, dead-unit rate "
          f"0.3, seed 0): trip -> shed -> half-open -> recover, "
          f"{json.dumps(block)} == BENCH_serving.json, registry == it; "
          f"{c_b['faulty_replay']} K6 launches; K6 equals its plain version "
          f"on all {len(errs6)} attempts of 9b, states and flip counts "
          f"(plain, stacked by shape: " + fmt_list(plain6) + " s)",
          flush=True)
    del calls, sigma_calls, b_tickets

    # -- 9c: the tracer on the card -----------------------------------------
    ch = serve_channel(dev, n_chips=SERVE_CHIPS)
    mix = mix_queue(bank_mod, get_op, lanes,
                    n_instrs=2 * SERVE_CHIPS * DDR4.n_banks)
    want = _flat(ch.dispatch(mix))                    # tables cached
    ch.reset_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    plain = _flat(ch.dispatch(mix))
    sync()
    wall_plain = time.perf_counter() - t0
    k5_plain = build.LAUNCHES["replay"]
    ch.reset_stats()
    build.reset_launches()
    with obs.enabled() as tr:
        t0 = time.perf_counter()
        traced = _flat(ch.dispatch(mix))
        sync()
        wall_traced = time.perf_counter() - t0
    k5_traced = build.LAUNCHES["replay"]
    check(all(np.array_equal(a, b) for a, b in zip(plain, want))
          and all(np.array_equal(a, b) for a, b in zip(traced, want)),
          "9c: the traced dispatch changed a result")
    check(k5_plain == k5_traced == ch.stats.super_rounds,
          f"9c: K5 launches {k5_plain} untraced, {k5_traced} traced, "
          f"{ch.stats.super_rounds} super-rounds")
    # the channel's own categories fold as its stats accumulate; the
    # banks' transpose charges the channel mirrors by chip differences,
    # another order of the same additions (as in the reference)
    st = ch.stats
    fields = {"channel.replay": st.latency_s,
              "channel.transfer.h2d": st.transfer_h2d_s,
              "channel.transfer.d2h": st.transfer_d2h_s,
              "channel.transfer.overlapped": st.transfer_overlapped_s}
    for cat, v in fields.items():
        check(tr.modeled_total(cat) == v,
              f"9c: {cat} {tr.modeled_total(cat)!r} != the stats' {v!r}")
    mirrored = {"transpose": st.transpose_s,
                "transpose_saved": st.transpose_s_saved}
    mirror_err = {c: abs(tr.modeled_total(c) - v) / max(abs(v), 1e-300)
                  for c, v in mirrored.items()}
    check(all(e <= BENCH_REL_TOL for e in mirror_err.values()),
          f"9c: the mirrored transpose fields are off: {mirror_err}")
    replay_spans = [s for r in tr.roots for s in r.walk()
                    if s.name == "channel.replay"]
    check(len(replay_spans) == k5_traced
          and all("device_s" in s.attrs for s in replay_spans),
          f"9c: {len(replay_spans)} channel.replay spans for {k5_traced} K5 "
          f"launches, or one has no device_s")
    trace_path = Path(record["trace_path"])
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    trace = obs.write_chrome_trace(str(trace_path), tracer=tr)
    spec = importlib.util.spec_from_file_location(
        "check_trace", ROOT / "scripts" / "check_trace.py")
    check_trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_trace)
    errors = check_trace.check_trace(trace)
    check(errors == [], f"9c: the Chrome trace fails check_trace: {errors}")
    # the device clock against the profiler's K5 time, round by round
    pairs, n_rounds, sessions = _traced_profiled(
        lambda: ch.dispatch(mix), ch.reset_stats, "channel.replay")
    device_ms = [pairs[i][0] for i in sorted(pairs)]
    prof_ms = [pairs[i][1] for i in sorted(pairs)]
    # printed, not checked: both are times
    off = [(i, (d - p) / p if p else None)
           for i, (d, p) in sorted(pairs.items())]
    print(f"[9c] device_s against the profiler's K5 time per round "
          f"(relative): {off}; "
          f"{sum(abs(d - p) > 0.05 * p + DEVICE_S_SLACK_MS for d, p in pairs.values())} "
          f"of {len(pairs)} rounds off by more than 5 % (+ "
          f"{DEVICE_S_SLACK_MS} ms)", flush=True)
    if len(pairs) < n_rounds:
        print(f"[9c] the profiler recorded the K5 launch of {len(pairs)} "
              f"of {n_rounds} rounds in {len(sessions)} sessions "
              f"({sessions}); the others are not compared", flush=True)
    overhead = wall_traced - wall_plain
    out["9c"] = {"wall_untraced_s": wall_plain, "wall_traced_s": wall_traced,
                 "overhead_s": overhead, "k5_launches": k5_traced,
                 "spans": tr.n_spans, "device_ms": device_ms,
                 "mirrored_rel_err": mirror_err,
                 "profiler_k5_ms": prof_ms, "profiler_sessions": sessions,
                 "rounds_compared": sorted(pairs),
                 "modeled_totals_s": {c: tr.modeled_total(c)
                                      for c in tr.modeled_categories()},
                 "trace": str(trace_path)}
    print(f"[9c] full-width channel dispatch of the mix queue "
          f"({len(mix)} x {lanes} lanes, {k5_traced} K5 launches): "
          f"untraced warm {wall_plain:.3f} s, traced warm {wall_traced:.3f} "
          f"s, tracer overhead {overhead:+.3f} s ({tr.n_spans} spans); "
          f"results and launches equal; channel.replay and "
          f"channel.transfer.* == their ChannelStats fields, transpose and "
          f"transpose_saved within {json.dumps(mirror_err)} relative of "
          f"the mirrored fields; device_s per round " + fmt_list(device_ms)
          + " ms vs profiler K5 " + fmt_list(prof_ms) + f" ms; Chrome trace "
          f"{trace_path} passes check_trace; {card}",
          flush=True)
    del ch, mix, want, plain, traced

    _agree(kern["replay"]["agreement"], "serving", counts["replay"],
           [r["max_abs_err"] for r in per_round])
    kern["replay"]["serving"] = {
        "launches": counts["replay"],
        "round_kernel_ms": [r["kernel_ms"] for r in per_round],
        "round_bound_ms": [r["bound_ms"] for r in per_round],
        "round_plain_s": [r["plain_s"] for r in per_round]}
    kern["faulty_replay"]["serving"] = {
        "launches": c_sigma["faulty_replay"] + c_b["faulty_replay"],
        "attempt_kernel_ms": k6_ms, "attempt_bound_ms": k6_bound[0],
        "group_plain_s": plain6}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[9] serving path: launches {total}; phase 9 took "
          f"{out['seconds']:.1f} s", flush=True)
    return total


# -- phase 10: the LM server ----------------------------------------------------

def release_device_memory(label: str = "10") -> None:
    """Free what the earlier phases left on the card (their collected
    tensors, the command-table cache, the allocator's cached blocks) and
    print what is free before phase ``label`` builds its model."""
    import gc

    import torch

    from repro_torch.core.control_unit import TABLE_CACHE
    TABLE_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[{label}] before phase {label}: {free / 2**30:.2f} GiB free of "
          f"{total / 2**30:.2f} GiB, {torch.cuda.memory_allocated() / 2**30:.3f}"
          f" GiB still allocated by this process", flush=True)


def _lm_close(got, want, what: str, tol: float = LM_TOL) -> float:
    """``got`` within ``tol`` of ``want`` (rtol and atol): the largest
    absolute difference."""
    g = got.detach().float().cpu()
    w = want.detach().float().cpu()
    check(g.shape == w.shape, f"{what}: shape {tuple(g.shape)} != "
          f"{tuple(w.shape)}")
    if not g.numel():
        return 0.0
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} of {g.numel()} entries differ by more "
          f"than rtol = atol = {tol}; largest {float(err.max()):.3e} "
          f"(got {float(g.flatten()[err.argmax()]):.6g}, want "
          f"{float(w.flatten()[err.argmax()]):.6g})")
    return float(err.max())


def _margins(logits):
    """Each row's top-1/top-2 logit margin and max |logit| (float32,
    host)."""
    import torch
    x = logits.detach().float().reshape(-1, logits.shape[-1])
    top2 = torch.topk(x, 2, dim=-1).values
    return ((top2[:, 0] - top2[:, 1]).cpu().numpy(),
            x.abs().amax(-1).cpu().numpy())


def _lm_tokens(got, want, tol, what: str, relative: bool = False) -> tuple:
    """Greedy tokens of ``got`` ``==`` those of ``want`` (the reference
    side) at every row whose top-1/top-2 margin exceeds ``2 * tol`` (of
    the row's max |logit| where ``relative``): (rows held, rows)."""
    import torch
    margin, top = _margins(want)
    thr = 2 * tol * (top if relative else 1.0)
    held = margin > thr
    g = torch.argmax(got.detach().float().reshape(-1, got.shape[-1]), -1)
    w = torch.argmax(want.detach().float().reshape(-1, want.shape[-1]), -1)
    diff = (g.cpu() != w.cpu()).numpy() & held
    check(not diff.any(), f"{what}: greedy tokens differ at rows "
          f"{np.flatnonzero(diff).tolist()} whose margins "
          f"{margin[diff].tolist()} exceed {np.broadcast_to(thr, margin.shape)[diff].tolist()}")
    return int(held.sum()), int(held.size)


def _lm_card_vs_cpu(dev, cfg, steps: int, quantize: bool = False) -> dict:
    """``lm_forward`` and ``steps`` decode steps of ``cfg`` (weights from
    one torch generator, optionally ``quantize_tree``'d) on the card and
    on the CPU, on the same weights and inputs: the largest differences
    of the logits, the aux loss, the decode logits and each cache (int8
    cache entries within 1, as a rounding at a half step may differ),
    and the greedy tokens held under the margin rule."""
    import torch

    from repro_torch.models.params import tree_map
    from repro_torch.models.quantized import quantize_tree
    from repro_torch.models.transformer import (decode_step, init_caches,
                                                init_lm, lm_forward)
    tree = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    if quantize:
        tree = quantize_tree(tree)
    on_card = tree_map(lambda t: t.to(dev), tree)
    rng = np.random.default_rng(0)
    b, l = 2, 16
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, l)))
    stubs = {}
    if cfg.is_encdec:
        stubs["encoder_feats"] = rng.normal(size=(b, 8, cfg.d_model))
    if cfg.family == "vlm":
        stubs["vision_embeds"] = rng.normal(
            size=(b, cfg.frontend_seq, cfg.d_model))
    stubs = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in stubs.items()}
    runs = {}
    with torch.no_grad():
        for where, m, d in (("cpu", tree, "cpu"), ("card", on_card, dev)):
            kw = {k: v.to(d) for k, v in stubs.items()}
            logits, aux = lm_forward(m, toks.to(d), cfg, **kw)
            caches = init_caches(cfg, b, 32, d)
            lgs = []
            for t in range(steps):
                lg, caches = decode_step(
                    m, caches, toks[:, t].to(d),
                    torch.full((b,), t, dtype=torch.int32, device=d), cfg,
                    memory=kw.get("encoder_feats"))
                lgs.append(lg)
            runs[where] = (logits, aux, torch.stack(lgs), caches)
    (lc, ac, dc, cc), (lg_, ag, dg, cg) = runs["cpu"], runs["card"]
    name = cfg.name + (" int8 weights" if quantize else "")
    errs = {"logits": _lm_close(lg_, lc, f"10a {name} logits"),
            "aux": _lm_close(ag, ac, f"10a {name} aux"),
            "decode": _lm_close(dg, dc, f"10a {name} decode logits")}
    held = [_lm_tokens(lg_, lc, LM_TOL, f"10a {name} forward"),
            _lm_tokens(dg, dc, LM_TOL, f"10a {name} decode")]
    for kind, c in cc.items():
        for leaf, want in c.items():
            got = cg[kind][leaf]
            what = f"10a {name} cache {kind}.{leaf}"
            check(got.dtype == want.dtype, f"{what}: dtype {got.dtype} != "
                  f"{want.dtype}")
            if want.dtype == torch.int8:
                e = int((got.cpu().to(torch.int64)
                         - want.to(torch.int64)).abs().max())
                check(e <= 1, f"{what}: int8 entries differ by {e} (at most "
                      f"1 allowed)")
                errs[f"{kind}.{leaf}"] = e
            else:
                errs[f"{kind}.{leaf}"] = _lm_close(got, want, what)
    errs["tokens_held"] = [sum(h for h, _ in held), sum(n for _, n in held)]
    return errs


def _k5_stacked(dev, rounds) -> tuple:
    """Each recorded round (``(states, CommandTables)`` of a chip
    executor) through K5, and the rounds of one state shape through the
    plain replay in one call (:func:`_stacked_plain`): (max_abs_err per
    round, plain s per group)."""
    import torch

    from repro_torch.core.control_unit import replay, replay_plain
    members = []
    for states_np, ct in rounds:
        tables, schedule = ct
        n_rows, n_words = states_np.shape[-2:]
        states = torch.from_numpy(np.ascontiguousarray(
            states_np.reshape(-1, n_rows, n_words)).view(np.int32)).to(dev)
        out = replay(states, ct)
        per_unit = tables if tables.dim() == 3 else tables.expand(
            states.shape[0], *tables.shape)
        members.append(((n_rows, n_words),
                        (states, per_unit[:, :int(schedule[0].max())]),
                        (out,)))
    errs, plain_s = _stacked_plain(
        members, lambda key, st, tables: (replay_plain(st, tables),))
    check(max(errs, default=0) == 0,
          f"10b: K5 disagrees with the plain replay: errors per round {errs}")
    return errs, plain_s


def _serve_burst(cfg, params, dev, prompts, offload=None) -> dict:
    """``prompts`` through a fresh ``Server`` of LM_SLOTS x LM_MAX_LEN:
    the tokens, the wall, each model step's time and, on the host, the
    logits each step's tokens were drawn from (after the offload)."""
    import torch

    from repro_torch.train.serve import Request, Server
    server = Server(cfg, params, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                    pum_offload=offload, device=dev)
    step_fn, step_s, logits = server.step_fn, [], []

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = step_fn(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        logits.append(res[0])
        return res

    server.step_fn = timed
    reqs = [Request(prompt=list(p), max_new=LM_MAX_NEW) for p in prompts]
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    server.run(max_steps=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.done for r in reqs),
          f"10b: {sum(not r.done for r in reqs)} of {len(reqs)} requests "
          f"did not complete in 256 steps")
    cache_bytes = sum(t.numel() * t.element_size()
                      for c in server.caches.values() for t in c.values())
    # the server wrote the offload's result into each step's logits
    return {"tokens": [r.out for r in reqs], "wall_s": wall,
            "step_s": step_s, "logits": [x.cpu() for x in logits],
            "cache_bytes": cache_bytes}


def _same_burst(got, want, what: str) -> int:
    """Two served bursts of one deterministic model: every step's logits
    and every request's tokens ``==``.  Returns the tokens compared."""
    import torch
    check(len(got["logits"]) == len(want["logits"]) and all(
        torch.equal(a, b) for a, b in zip(got["logits"], want["logits"])),
        f"{what}: the logits differ at steps "
        f"{[i for i, (a, b) in enumerate(zip(got['logits'], want['logits'])) if not torch.equal(a, b)]}"
        f" of {len(got['logits'])} (against {len(want['logits'])})")
    check(got["tokens"] == want["tokens"], f"{what}: tokens {got['tokens']} "
          f"!= {want['tokens']}")
    return sum(len(t) for t in got["tokens"])


def lm_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 10: the LM stack.  10a every arch at smoke_config, card
    against CPU, the int8 cache, int8 weights and the PuM MLP on K3; 10b
    yi-6b at full width serving a burst through PumServeOffload (K5);
    10c make_prefill against decode at full width.  Every K3 and K5
    launch of the counted runs has its twin through the plain version;
    returns their launch counts, summed."""
    import torch

    from repro_torch.configs import ARCHS, get_config, smoke_config
    from repro_torch.core.chip import SimdramChip
    from repro_torch.kernels import build
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import init_caches, init_lm, lm_forward
    from repro_torch.train.serve import (PumServeOffload, make_prefill,
                                         make_serve_step)

    card = record["card"]
    out = record["lm"] = {}
    total = {k: 0 for k in build.LAUNCHES}
    t_phase = time.perf_counter()

    # -- 10a: every arch at smoke_config, card against CPU ---------------
    phase("10a")
    smoke = {}
    for arch in sorted(ARCHS):
        smoke[arch] = _lm_card_vs_cpu(
            dev, smoke_config(arch).replace(param_dtype="float32"), steps=2)
    yi = smoke_config(LM_ARCH).replace(param_dtype="float32")
    smoke["yi-6b int8 cache"] = _lm_card_vs_cpu(
        dev, yi.replace(kv_cache_dtype="int8"), steps=4)
    smoke["yi-6b int8 weights"] = _lm_card_vs_cpu(dev, yi, steps=2,
                                                  quantize=True)
    # tests/test_system.py::test_pum_offload_inside_lm's configuration:
    # the MLP's relu as a bbop, K3 on the card
    pum = smoke_config("seamless-m4t-medium").replace(
        act="relu", pum="bitplane", pum_bits=8, param_dtype="float32")
    build.reset_launches()
    smoke["seamless-m4t-medium pum"] = _lm_card_vs_cpu(dev, pum, steps=2)
    counts_a = dict(build.LAUNCHES)
    want_k3 = pum.n_layers + pum.n_encoder_layers + 2 * pum.n_layers
    check(counts_a["circuit"] == want_k3 and all(
        v == 0 for k, v in counts_a.items() if k != "circuit"),
        f"10a: the PuM MLP launched {counts_a}, expected {want_k3} K3 "
        f"launches (one a layer: the forward's encoder and decoder layers "
        f"and the two decode steps' decoder layers) and nothing else")
    with _Twins() as tw:
        _lm_card_vs_cpu(dev, pum, steps=2)
    errs_k3 = tw.errs["circuit"]
    check(len(errs_k3) == counts_a["circuit"] and max(errs_k3, default=0) == 0,
          f"10a: {len(errs_k3)} K3 twins for {counts_a['circuit']} "
          f"launches, errors {errs_k3}")
    for k, v in counts_a.items():
        total[k] += v
    _agree(kern["circuit"]["agreement"], "lm", counts_a["circuit"], errs_k3)
    worst = {name: max(v for k, v in e.items() if k != "tokens_held")
             for name, e in smoke.items()}
    held = [sum(e["tokens_held"][i] for e in smoke.values()) for i in (0, 1)]
    out["10a"] = {"max_abs_err": smoke, "k3_launches": counts_a["circuit"],
                  "tolerance": f"rtol = atol = {LM_TOL}; int8 cache entries "
                               f"1; greedy tokens == where the CPU's "
                               f"top-1/top-2 margin > {2 * LM_TOL}"}
    print(f"[10a] {len(ARCHS)} archs at smoke_config (float32), the int8 "
          f"cache, int8 weights and the PuM MLP: card == CPU within rtol = "
          f"atol = {LM_TOL} (int8 cache entries within 1); largest "
          f"differences " + ", ".join(f"{k} {v:.2e}" for k, v in
                                      worst.items())
          + f"; greedy tokens equal at {held[0]} of {held[1]} positions "
          f"(those with a margin above {2 * LM_TOL}); the PuM MLP made "
          f"{counts_a['circuit']} K3 launches, each equal to the plain "
          f"circuit; {card}", flush=True)

    # -- 10b: yi-6b at full width, served ------------------------------------
    phase("10b")
    t_b = time.perf_counter()
    cfg = get_config(LM_ARCH).replace(n_layers=LM_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(0),
                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == cfg.param_count(), f"10b: {n_params} parameters, "
          f"param_count() {cfg.param_count()}")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]
               for n in LM_PROMPTS]
    chip = SimdramChip(n_banks=4, n_subarrays=2, device=dev)
    offload = PumServeOffload(chip=chip)
    steps, warm_steps, rounds = [], [], []
    into = [steps]
    executor = chip.executor

    def watched(x):
        """The offload of one step, timed; its result must be the logits
        it was given (the default stages are a grid no-op) and
        ``offload.reference``'s, bit for bit."""
        r0, k0 = chip.stats.rounds, build.LAUNCHES["replay"]
        t = time.perf_counter()
        y = offload(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        check(np.array_equal(y, x), f"10b: step {len(into[0])}: the offload "
              f"changed {int((y != x).sum())} of {x.size} logits")
        into[0].append({"ms": ms, "rows": x.shape[0],
                        "rounds": chip.stats.rounds - r0,
                        "k5": build.LAUNCHES["replay"] - k0, "x": x})
        return y

    # the first burst warms the model's kernels up; the counted burst goes
    # through the offload (its chip compiles its tables); then warm bursts
    # with and without it, timed.  Under deterministic algorithms (and the
    # fixed cuBLAS workspace main() sets) the model's steps are the same
    # on the same inputs, so every burst's logits must equal the first's
    # bit for bit: the offload gives back the logits it was given.  (New
    # tensors are left unfilled, as they are outside this mode: filling
    # them would only slow the timed bursts.)
    import torch.utils.deterministic as deterministic
    fill = deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    deterministic.fill_uninitialized_memory = False
    try:
        plain = _serve_burst(cfg, params, dev, prompts)
        chip.executor = _recording(executor, rounds)
        build.reset_launches()
        pum_run = _serve_burst(cfg, params, dev, prompts, watched)
        counts_b = dict(build.LAUNCHES)
        rounds_b = chip.stats.rounds
        chip.executor = executor
        into[0] = warm_steps
        warm_pum = _serve_burst(cfg, params, dev, prompts, watched)
        warm = _serve_burst(cfg, params, dev, prompts)
    finally:
        torch.use_deterministic_algorithms(False)
        deterministic.fill_uninitialized_memory = fill
    check(counts_b["replay"] == rounds_b > 0 and all(
        v == 0 for k, v in counts_b.items() if k != "replay"),
        f"10b: launches {counts_b} for {rounds_b} chip rounds in the counted "
        f"burst, expected one K5 launch a round and nothing else")
    check(all(s["k5"] == s["rounds"] for s in steps),
          f"10b: K5 launches per step {[s['k5'] for s in steps]}, chip "
          f"rounds per step {[s['rounds'] for s in steps]}")
    check(len(rounds) == counts_b["replay"],
          f"10b: {len(rounds)} recorded rounds, {counts_b['replay']} K5 "
          f"launches")
    bad = [i for i, s in enumerate(steps + warm_steps)
           if not np.array_equal(offload.reference(s["x"]), s["x"])]
    check(not bad, f"10b: offload.reference differs from the offload at "
          f"steps {bad}")
    n_same = _same_burst(pum_run, plain, "10b: the burst through the "
                         "offload against the plain burst")
    n_warm = _same_burst(warm, plain, "10b: a warm plain burst against the "
                         "first")
    n_warm_pum = _same_burst(warm_pum, plain, "10b: a warm burst through "
                             "the offload against the plain burst")
    for k, v in counts_b.items():
        total[k] += v
    errs_k5, plain_s = _k5_stacked(dev, rounds)
    del rounds
    _agree(kern["replay"]["agreement"], "lm", counts_b["replay"], errs_k5)
    k5_per_step = [s["k5"] for s in steps]
    noop_rows = sum(s["rows"] for s in steps + warm_steps)
    n_tokens = sum(len(t) for t in pum_run["tokens"])
    offload_ms = [s["ms"] for s in steps]
    warm_offload_ms = [s["ms"] for s in warm_steps]
    for s in steps + warm_steps:
        del s["x"]
    # a few served steps under the profiler: the card's idle share
    prof = device_breakdown(lambda: _serve_burst(cfg, params, dev,
                                                 prompts[:LM_SLOTS],
                                                 offload))
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)) \
        - params["embed"]["emb"].numel() * params["embed"]["emb"].element_size()
    step_bound = bound(w_bytes + plain["cache_bytes"], 0)
    step_ms = float(np.median(warm_pum["step_s"])) * 1e3
    step_plain_ms = float(np.median(warm["step_s"])) * 1e3
    out["10b"] = {
        "init_s": init_s, "params": n_params, "steps": len(pum_run["step_s"]),
        "tokens": pum_run["tokens"], "generated": n_tokens,
        "tokens_compared_offload_vs_plain": n_same,
        "tokens_compared_warm_vs_first": n_warm,
        "tokens_compared_warm_offload_vs_plain": n_warm_pum,
        "offload_noop_rows": noop_rows,
        "wall_plain_first_s": plain["wall_s"],
        "wall_offload_first_s": pum_run["wall_s"],
        "wall_offload_s": warm_pum["wall_s"], "wall_plain_s": warm["wall_s"],
        "tokens_per_s_offload": n_tokens / warm_pum["wall_s"],
        "tokens_per_s_plain": n_tokens / warm["wall_s"],
        "model_step_ms_median": step_ms,
        "model_step_ms_median_plain": step_plain_ms,
        "model_step_ms": [t * 1e3 for t in warm_pum["step_s"]],
        "offload_ms_median": float(np.median(warm_offload_ms)),
        "offload_ms": warm_offload_ms,
        "offload_ms_median_first": float(np.median(offload_ms)),
        "offload_ms_first": offload_ms, "k5_per_step": k5_per_step,
        "k5_launches": counts_b["replay"], "k5_plain_s": plain_s,
        "chip_stats": chip.stats.as_dict(),
        "weight_bytes_per_step": w_bytes, "cache_bytes": plain["cache_bytes"],
        "step_bound_ms": step_bound[0],
        "profiled": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                          "idle_share", "device_ms")}}
    print(f"[10b] {LM_ARCH} at full width, {cfg.n_layers} of "
          f"{get_config(LM_ARCH).n_layers} layers ({n_params:,} parameters == "
          f"param_count(), bf16, initialized on the card in {init_s:.2f} s): "
          f"{len(prompts)} requests, {n_tokens} tokens in "
          f"{len(pum_run['step_s'])} steps on {LM_SLOTS} slots of "
          f"{LM_MAX_LEN} positions, all complete; every step's offload "
          f"returned the logits it was given and offload.reference's, bit "
          f"for bit ({noop_rows} no-op rows in two bursts); under "
          f"deterministic algorithms every step's logits and every token "
          f"of the bursts through the offload == the plain burst's "
          f"({n_same} tokens; warm: {n_warm_pum}), a warm plain burst's "
          f"== the first's ({n_warm}); {card}", flush=True)
    print(f"[10b] warm: model step {step_ms:.2f} ms median with the "
          f"offload ({step_plain_ms:.2f} ms without), offload "
          f"{out['10b']['offload_ms_median']:.2f} ms median (counted burst "
          f"{out['10b']['offload_ms_median_first']:.2f}), K5 launches a "
          f"step {sorted(set(k5_per_step))} (= the chip's stacked rounds, "
          f"{counts_b['replay']} in all, each equal to the plain replay, "
          f"stacked by shape: " + fmt_list(plain_s) + f" s); "
          f"{n_tokens / warm_pum['wall_s']:.2f} tokens/s with the offload, "
          f"{n_tokens / warm['wall_s']:.2f} without (the first bursts "
          f"{pum_run['wall_s']:.2f} and {plain['wall_s']:.2f} s); decode "
          f"step bound "
          f"{step_bound[0]:.3f} ms ({w_bytes / 1e9:.2f} GB of weights + "
          f"{plain['cache_bytes'] / 1e9:.3f} GB of cache over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); {card}", flush=True)
    note_profiled("10b", "replay_kernel", prof)
    print(f"[10b] a profiled burst of {LM_SLOTS} requests through the "
          f"offload: wall {prof['wall_ms']:.1f} ms, card busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.4f}; top device ms "
          + json.dumps(dict(list(prof["device_ms"].items())[:8]))
          + f"; {card}", flush=True)
    del plain, pum_run, warm, warm_pum

    # -- 10c: make_prefill against decode at full width ----------------------
    phase("10c")
    t_c = time.perf_counter()
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                         (1, LM_PREFILL_LEN))).to(dev)
    prefill = make_prefill(cfg)
    step = make_serve_step(cfg)
    with torch.no_grad():
        full, _ = lm_forward(params, toks, cfg)
    last = prefill(params, toks)
    # the prompt decoded position by position through make_serve_step's
    # step, replayed as one CUDA graph a step (the same kernels on the
    # same tensors, without the host's launch time)
    caches = init_caches(cfg, 1, LM_PREFILL_LEN, dev)
    graph, tok, pos, logits = _graphed_step(step, params, caches, dev)
    dec = torch.empty((LM_PREFILL_LEN, logits.shape[-1]), dtype=logits.dtype,
                      device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(LM_PREFILL_LEN):
        tok.copy_(toks[0, t:t + 1])
        pos.fill_(t)
        graph.replay()
        dec[t].copy_(logits[0])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    want = full[0].float()

    def rel_err(d):
        w = want[:d.shape[0]]
        return ((d.float() - w).abs().amax(-1) / w.abs().amax(-1)).cpu().numpy()

    rel = rel_err(dec)
    # two planted faults over the first LM_FAULT_LEN positions, each of
    # which the tolerance must catch: the cache write of position
    # LM_FAULT_AT dropped (its keys and values zeroed after its step), and
    # every step one position late (the empty slot 0 is attended to)
    faults = {}
    for fault in ("dropped cache write", "position off by one"):
        for c in caches.values():
            for x in c.values():
                x.zero_()           # a bf16 cache starts at zero
        bad_dec = torch.empty_like(dec[:LM_FAULT_LEN])
        for t in range(LM_FAULT_LEN):
            tok.copy_(toks[0, t:t + 1])
            pos.fill_(t + 1 if fault == "position off by one" else t)
            graph.replay()
            if fault == "dropped cache write" and t == LM_FAULT_AT:
                for x in caches["attn"].values():
                    x[:, :, t].zero_()
            bad_dec[t].copy_(logits[0])
        r = rel_err(bad_dec)
        faults[fault] = {"max_rel": float(r.max()),
                         "positions_over_tolerance": int((r > LM_BF16_REL).sum()),
                         "positions": LM_FAULT_LEN}
        check(r.max() > LM_BF16_REL, f"10c: a planted fault ({fault}) reads "
              f"{float(r.max()):.3e} of max|logits| at most, within the "
              f"tolerance {LM_BF16_REL}")
    del graph, caches, bad_dec
    held = _lm_tokens(dec, full[0], LM_BF16_REL, "10c decode against the "
                      "prefill", relative=True)
    bad = np.flatnonzero(rel > LM_BF16_REL)
    check(not len(bad), f"10c: decode against prefill off by more than "
          f"{LM_BF16_REL} of max|logits| at positions {bad[:16].tolist()}: "
          f"{rel[bad[:16]].tolist()}")
    # make_prefill's own output (the last position) against that decode
    want = last.float()
    rel_last = float((dec[-1].float() - want).abs().max() / want.abs().max())
    _lm_tokens(dec[-1:], last, LM_BF16_REL, "10c make_prefill's last "
               "position", relative=True)
    check(rel_last <= LM_BF16_REL, f"10c: make_prefill's last position off "
          f"the decode's by {rel_last:.3e} of max|logits|, tolerance "
          f"{LM_BF16_REL}")
    rel = rel.tolist()
    del full, dec
    prefill_ms = time_ms(lambda: prefill(params, toks), reps=3, warmup=1)
    mm = sum(t.numel() for k, t in _matmul_weights(params))
    flops = (2 * mm * LM_PREFILL_LEN + cfg.n_layers * 4 * cfg.n_heads
             * LM_PREFILL_LEN ** 2 * cfg.hd)
    prefill_bound = bound(0, flops, BF16_FLOPS_PER_S)
    peak = torch.cuda.max_memory_allocated()
    out["10c"] = {"decode_vs_prefill_rel": rel, "planted_faults": faults,
                  "make_prefill_last_rel": rel_last,
                  "tolerance": f"{LM_BF16_REL} of max|logits| per position; "
                               f"greedy tokens == where the prefill's margin "
                               f"> {2 * LM_BF16_REL} of it",
                  "tokens_held": held, "decode_s": decode_s,
                  "graphed_step_ms": decode_s / LM_PREFILL_LEN * 1e3,
                  "prefill_ms": prefill_ms, "prefill_tokens": LM_PREFILL_LEN,
                  "prefill_flops": flops,
                  "prefill_bound_ms": prefill_bound[0],
                  "max_memory_allocated": peak}
    print(f"[10c] lm_forward (make_prefill's forward) over {LM_PREFILL_LEN} "
          f"tokens against {LM_PREFILL_LEN} decode steps (one CUDA graph a "
          f"step, {decode_s / LM_PREFILL_LEN * 1e3:.2f} ms a step): largest "
          f"difference {max(rel):.3e} of max|logits|, median "
          f"{float(np.median(rel)):.3e} (tolerance "
          f"{LM_BF16_REL}), greedy tokens equal at {held[0]} of {held[1]} "
          f"positions (those with a margin above {2 * LM_BF16_REL} of "
          f"max|logits|); make_prefill's own last position off the "
          f"decode's by {rel_last:.3e}; planted faults over the first "
          f"{LM_FAULT_LEN} positions read " + ", ".join(
              f"{k} (at {LM_FAULT_AT}) {v['max_rel']:.3e}" if k.startswith(
                  "dropped") else f"{k} {v['max_rel']:.3e}"
              for k, v in faults.items())
          + f" ({' and '.join(str(v['positions_over_tolerance']) for v in faults.values())}"
          f" of {LM_FAULT_LEN} positions over the tolerance); make_prefill "
          f"{prefill_ms:.1f} ms (CUDA events), bound "
          f"{prefill_bound[0]:.1f} ms ({flops / 1e12:.1f} TFLOP over "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense bf16); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; {card}", flush=True)
    del params, toks
    torch.cuda.empty_cache()

    kern["circuit"]["lm"] = {"launches": counts_a["circuit"]}
    kern["replay"]["lm"] = {"launches": counts_b["replay"],
                            "per_step": k5_per_step,
                            "round_plain_s": plain_s}
    t_end = time.perf_counter()
    out["seconds"] = t_end - t_phase
    out["part_seconds"] = {"10a": t_b - t_phase, "10b": t_c - t_b,
                           "10c": t_end - t_c}
    print(f"[10] LM path: launches {total}; phase 10 took "
          f"{out['seconds']:.1f} s ({json.dumps(out['part_seconds'])})",
          flush=True)
    return total


def _train_batches(cfg, dev, steps: int, data=TRAIN_SMOKE_DATA) -> list:
    """``synth_batch`` of steps 0 .. ``steps`` - 1 as tensors on ``dev``."""
    import torch

    from repro_torch.train.data import DataConfig, synth_batch
    return [{k: torch.from_numpy(v).to(dev) for k, v in synth_batch(
        cfg, DataConfig(*data), s).items()} for s in range(steps)]


def _train_card_vs_cpu(dev, cfg, n_microbatches: int = 1) -> dict:
    """TRAIN_SMOKE_STEPS train steps of ``cfg`` (weights from one torch
    generator) on the card and on the CPU, on the same weights and
    batches: the largest differences of each step's loss, aux and grad
    norm and of every final parameter, each within LM_TOL."""
    import torch

    from repro_torch.models.params import flatten, tree_map
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import make_train_step
    tree = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    step = make_train_step(cfg, opt.AdamWConfig(**TRAIN_SMOKE_OPT),
                           n_microbatches=n_microbatches)
    runs = {}
    for where, d in (("cpu", "cpu"), ("card", dev)):
        params = tree_map(lambda t: t.to(d), tree)
        state, metrics = opt.init(params), []
        for b in _train_batches(cfg, d, TRAIN_SMOKE_STEPS):
            params, state, m = step(params, state, b)
            metrics.append(m)
        runs[where] = (params, metrics)
    (pc, mc), (pg, mg) = runs["cpu"], runs["card"]
    name = f"12a {cfg.name}" + (f" {n_microbatches} microbatches"
                                if n_microbatches > 1 else "")
    errs = {}
    for k in ("loss", "aux", "grad_norm"):
        errs[k] = max(_lm_close(g[k], c[k], f"{name} step {i + 1} {k}")
                      for i, (g, c) in enumerate(zip(mg, mc)))
    errs["params"] = max(_lm_close(g, c, f"{name} parameter leaf {i}")
                         for i, (g, c) in enumerate(zip(flatten(pg),
                                                        flatten(pc))))
    check(all(bool(torch.isfinite(m["loss"])) for m in mg),
          f"{name}: a loss on the card is not finite")
    return errs


def _grad_tree(cfg):
    """The gradient tree of one float32 smoke forward of ``cfg`` on the
    CPU (``make_loss_fn`` on one batch)."""
    import torch

    from repro_torch.models.params import flatten, tree_map, unflatten
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.train_loop import make_loss_fn
    live = tree_map(lambda t: t.requires_grad_(), init_lm(
        cfg, generator=torch.Generator().manual_seed(1), device="cpu"))
    total, _ = make_loss_fn(cfg)(live, _train_batches(cfg, "cpu", 1)[0])
    return unflatten(live, torch.autograd.grad(total, flatten(live)))


class _Timed:
    """Within ``with``: each call of ``mod.<name>`` for ``names`` is timed
    on the host's clock (after a device synchronize) into
    ``seconds[name]``."""

    def __init__(self, mod, *names):
        self.mod, self.names = mod, names
        self.seconds = {n: [] for n in names}

    def __enter__(self):
        import torch
        self.orig = {n: getattr(self.mod, n) for n in self.names}

        def timed(name, fn):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds[name].append(time.perf_counter() - t)
                return out
            return call

        for n, fn in self.orig.items():
            setattr(self.mod, n, timed(n, fn))
        return self.seconds

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)


def _flip_a_byte(path: Path) -> None:
    """XOR one byte in the middle of ``path`` with 0xFF, in place."""
    with open(path, "r+b") as f:
        f.seek(path.stat().st_size // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def train_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 12: the trainer.  12a every arch at smoke_config, train steps
    on the card against the CPU, two microbatches, the PuM relu MLP on K3
    (every K3 launch of the counted steps has its twin through the plain
    circuit) and the compressed gradient transform; 12b internvl2-1b at
    full width through ``launch.train.train``, checkpointed, moved and
    resumed bit for bit.  Returns the training path's launch counts."""
    import shutil

    import torch

    from repro_torch.configs import ARCHS, get_config, smoke_config
    from repro_torch.kernels import build
    from repro_torch.launch.train import train
    from repro_torch.models.params import flatten, tree_map
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.compression import compressed_grad_transform
    from repro_torch.train.train_loop import make_train_step

    card = record["card"]
    out = record["train"] = {}
    total = {k: 0 for k in build.LAUNCHES}
    t_phase = time.perf_counter()

    # -- 12a: every arch at smoke_config, card against CPU ---------------
    phase("12a")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "12a: TF32 is on for float32 products")
    smoke = {}
    for arch in sorted(ARCHS):
        smoke[arch] = _train_card_vs_cpu(
            dev, smoke_config(arch).replace(param_dtype="float32"))
    yi = smoke_config(LM_ARCH).replace(param_dtype="float32")
    smoke[f"{LM_ARCH} 2 microbatches"] = _train_card_vs_cpu(dev, yi, 2)
    # tests/test_system.py::test_pum_offload_inside_lm's configuration:
    # the MLP's relu a bbop on K3, in every forward and every recompute
    pum = smoke_config("seamless-m4t-medium").replace(
        act="relu", pum="bitplane", pum_bits=8, param_dtype="float32")
    build.reset_launches()
    smoke["seamless-m4t-medium pum"] = _train_card_vs_cpu(dev, pum)
    counts_a = dict(build.LAUNCHES)
    check(counts_a["circuit"] > 0 and all(
        v == 0 for k, v in counts_a.items() if k != "circuit"),
        f"12a: the PuM MLP's train steps launched {counts_a}, expected K3 "
        f"launches and nothing else")
    with _Twins() as tw:
        _train_card_vs_cpu(dev, pum)
    errs_k3 = tw.errs["circuit"]
    check(len(errs_k3) == counts_a["circuit"] and max(errs_k3, default=0) == 0,
          f"12a: {len(errs_k3)} K3 twins for {counts_a['circuit']} "
          f"launches, errors {errs_k3}")
    for k, v in counts_a.items():
        total[k] += v
    _agree(kern["circuit"]["agreement"], "train", counts_a["circuit"],
           errs_k3)
    grads = _grad_tree(yi)
    rng = np.random.default_rng(2)
    res = tree_map(lambda g: torch.from_numpy(
        1e-3 * rng.standard_normal(tuple(g.shape)).astype(np.float32)), grads)
    want = compressed_grad_transform(res)(grads)
    got = compressed_grad_transform(tree_map(lambda t: t.to(dev), res))(
        tree_map(lambda t: t.to(dev), grads))
    n_comp = 0
    for g, w in zip(flatten(got), flatten(want)):
        check(torch.equal(g.cpu(), w), "12a: compressed_grad_transform on "
              "the card differs from the CPU's")
        n_comp += w.numel()
    worst = {name: max(e.values()) for name, e in smoke.items()}
    out["12a"] = {"max_abs_err": smoke, "k3_launches": counts_a["circuit"],
                  "compressed_values": n_comp,
                  "tolerance": f"rtol = atol = {LM_TOL}; "
                               f"compressed_grad_transform =="}
    print(f"[12a] {len(ARCHS)} archs at smoke_config (float32), yi-6b in "
          f"2 microbatches and the PuM relu MLP: {TRAIN_SMOKE_STEPS} train "
          f"steps on the card == CPU within rtol = atol = {LM_TOL} (loss, "
          f"aux, grad norm, every parameter); largest differences "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; the PuM steps made {counts_a['circuit']} K3 launches, each "
          f"equal to the plain circuit; compressed_grad_transform == over "
          f"{n_comp:,} gradient values; {card}", flush=True)

    # -- 12b: internvl2-1b at full width, checkpointed and resumed -----------
    phase("12b")
    t_b = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    root = ROOT / "build" / "train_ckpt"
    a, b = root / "A", root / "B"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    disk = shutil.disk_usage(root)
    print(f"[12b] {disk.free / 1e9:.1f} GB free on the disk of {root}",
          flush=True)
    kw = dict(arch=TRAIN_ARCH, smoke=False, steps=TRAIN_STEPS,
              seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
              n_microbatches=TRAIN_MICRO, ckpt_every=TRAIN_CKPT_EVERY,
              device=dev)
    import torch.utils.deterministic as deterministic
    fill = deterministic.fill_uninitialized_memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        # under deterministic algorithms (and the fixed cuBLAS workspace
        # main() sets) the resumed run must repeat the first bit for bit
        torch.use_deterministic_algorithms(True)
        deterministic.fill_uninitialized_memory = False
        with _Timed(ckpt, "save", "restore") as io_s:
            ra = train(ckpt_dir=str(a), **kw)
            check(ckpt.latest_step(str(a)) == TRAIN_STEPS
                  and ckpt.latest_step(str(a) + "_opt") == TRAIN_STEPS,
                  f"12b: run A's checkpoints end at step "
                  f"{ckpt.latest_step(str(a))}, expected {TRAIN_STEPS}")
            for suffix in ("", "_opt"):
                (root / f"B{suffix}").mkdir()
                shutil.move(root / f"A{suffix}" / f"step_{TRAIN_CKPT_EVERY:08d}",
                            root / f"B{suffix}" / f"step_{TRAIN_CKPT_EVERY:08d}")
                shutil.rmtree(root / f"A{suffix}")
            rb = train(ckpt_dir=str(b), **kw)
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(False)
        deterministic.fill_uninitialized_memory = fill
    # param_count() counts the published vocabulary and no modality stub:
    # add the embedding's and readout's padded rows and the vision stub's
    # projection
    n_params = sum(t.numel() for t in flatten(ra["params"]))
    unpublished = ((cfg.vocab_padded - cfg.vocab_size) * cfg.d_model
                   * (1 if cfg.tie_embeddings else 2)
                   + (cfg.d_model ** 2 if cfg.frontend else 0))
    check(n_params == cfg.param_count() + unpublished,
          f"12b: {n_params} parameters, param_count() {cfg.param_count()} "
          f"+ {unpublished} of padded vocabulary and the vision stub")
    check(all(np.isfinite(r["loss"]) for r in ra["logs"] + rb["logs"]),
          f"12b: a loss is not finite: {[r['loss'] for r in ra['logs']]}, "
          f"{[r['loss'] for r in rb['logs']]}")
    resumed = [r["step"] for r in rb["logs"]]
    check(resumed == list(range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS + 1)),
          f"12b: the run from B's checkpoints logged steps {resumed}")
    pairs = list(zip(rb["logs"], ra["logs"][TRAIN_CKPT_EVERY:]))
    check(all((x["loss"], x["grad_norm"]) == (y["loss"], y["grad_norm"])
              for x, y in pairs),
          f"12b: resumed losses and grad norms "
          f"{[(x['loss'], x['grad_norm']) for x, _ in pairs]} != run A's "
          f"{[(y['loss'], y['grad_norm']) for _, y in pairs]}")
    leaves_a, leaves_b = flatten(ra["params"]), flatten(rb["params"])
    differ = [i for i, (x, y) in enumerate(zip(leaves_b, leaves_a))
              if not torch.equal(x, y)]
    check(not differ, f"12b: the resumed run's final parameter leaves "
          f"{differ} differ from run A's")
    # the step's FLOPs: every weight product (the blocks' over every
    # position, the readout over the text, the vision stub's projection
    # over the patches) and attention's two batched products, forward
    # and twice that backward
    positions = TRAIN_BATCH * (cfg.frontend_seq + TRAIN_SEQ)
    text = TRAIN_BATCH * TRAIN_SEQ
    over = {"blocks": positions, "out": text,
            "frontend_proj": TRAIN_BATCH * cfg.frontend_seq}
    mm = sum(t.numel() * over[path.split(".")[0]]
             for path, t in _matmul_weights(ra["params"]))
    attn = (cfg.n_layers * 4 * TRAIN_BATCH * cfg.n_heads
            * (cfg.frontend_seq + TRAIN_SEQ) ** 2 * cfg.hd)
    flops = 3 * (2 * mm + attn)
    step_bound = bound(0, flops, BF16_FLOPS_PER_S)
    # AdamW reads the bf16 params, the fp32 gradients (summed over the
    # microbatches) and both moments and writes the params and moments
    opt_bytes = n_params * (2 + 4 + 8 + 2 + 8)
    del ra["params"], leaves_a
    # a flipped byte in a saved shard must make restore raise
    _flip_a_byte(b / f"step_{TRAIN_STEPS:08d}" / "shard_0.npz")
    try:
        ckpt.restore(str(b), TRAIN_STEPS, rb["params"], device=dev)
    except Exception as e:          # noqa: BLE001 -- any refusal will do
        refused = f"{type(e).__name__}: {e}"
    else:
        refused = None
    check(refused is not None, "12b: restore read a shard with a flipped "
          "byte without complaint")
    ckpt_bytes = {d.name: sum(f.stat().st_size for f in d.rglob("*")
                              if f.is_file()) for d in root.iterdir()}
    shutil.rmtree(root, ignore_errors=True)
    # one more step of B's model, profiled: the card's idle share
    step_fn = make_train_step(cfg, opt.AdamWConfig(
        lr=3e-4, warmup_steps=max(2, TRAIN_STEPS // 10),
        total_steps=TRAIN_STEPS), n_microbatches=TRAIN_MICRO)
    batch = _train_batches(cfg, dev, 1, (TRAIN_SEQ, TRAIN_BATCH, 0))[0]
    held = list(step_fn(rb["params"], opt.init(rb["params"]), batch)[:2])
    del rb["params"], leaves_b

    def one_step():
        held[:] = step_fn(held[0], held[1], batch)[:2]

    prof = device_breakdown(one_step)
    del held, batch
    torch.cuda.empty_cache()

    steps_s = [r["sec"] for r in ra["logs"] + rb["logs"]]
    step_s = float(np.median(steps_s[1:]))
    save_s, restore_s = io_s["save"], io_s["restore"]
    out["12b"] = {
        "params": n_params, "param_count": cfg.param_count(),
        "losses": [r["loss"] for r in ra["logs"]],
        "resumed_losses": [r["loss"] for r in rb["logs"]],
        "grad_norms": [r["grad_norm"] for r in ra["logs"]],
        "step_s": steps_s, "step_s_median": step_s,
        "positions_per_step": positions, "text_tokens_per_step": text,
        "positions_per_s": positions / step_s,
        "text_tokens_per_s": text / step_s,
        "save_s": save_s, "restore_s": restore_s,
        "checkpoint_bytes": ckpt_bytes, "disk_free_bytes": disk.free,
        "corrupt_restore_refused": refused,
        "max_memory_allocated": peak, "step_flops": flops,
        "step_bound_ms": step_bound[0], "optimizer_bytes": opt_bytes,
        "optimizer_bound_ms": bound(opt_bytes, 0)[0],
        "profiled_step": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                               "idle_share", "device_ms")}}
    print(f"[12b] {TRAIN_ARCH} at full width ({n_params:,} parameters: "
          f"param_count() {cfg.param_count():,} + {unpublished:,} of padded "
          f"vocabulary and the vision stub; bf16, fp32 moments): "
          f"{TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x ({cfg.frontend_seq} + {TRAIN_SEQ}) positions "
          f"in {TRAIN_MICRO} microbatches, losses "
          + fmt_list([r["loss"] for r in ra["logs"]])
          + f", all finite; its step-{TRAIN_CKPT_EVERY} checkpoints, moved "
          f"to another directory, resumed the same call at step "
          f"{resumed[0]} and, under deterministic algorithms, steps "
          f"{resumed[0]}-{resumed[-1]}'s losses and grad norms and the "
          f"final parameters == the uninterrupted run's, bit for bit; a "
          f"flipped byte in a shard was refused ({refused.split(':')[0]}); "
          f"{card}", flush=True)
    print(f"[12b] step {step_s * 1e3:.1f} ms median (host clock, steps 2-"
          f"{TRAIN_STEPS} and the resumed 3; the first "
          f"{steps_s[0] * 1e3:.1f} ms), {positions / step_s:,.0f} positions/s"
          f" ({text / step_s:,.0f} text tokens/s); FLOP bound "
          f"{step_bound[0]:.1f} ms ({flops / 1e12:.2f} TFLOP over "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense bf16), AdamW's "
          f"bytes bound {bound(opt_bytes, 0)[0]:.2f} ms ({opt_bytes / 1e9:.1f}"
          f" GB over {HBM_BYTES_PER_S / 1e12:.2f} TB/s); saves "
          + fmt_list(save_s) + " s, restores " + fmt_list(restore_s)
          + f" s ({json.dumps({k: round(v / 1e9, 3) for k, v in ckpt_bytes.items()})}"
          f" GB on disk at the end); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; {card}", flush=True)
    print(f"[12b] one profiled step: wall {prof['wall_ms']:.1f} ms, card "
          f"busy {prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.4f}; top device ms "
          + json.dumps(dict(list(prof["device_ms"].items())[:8]))
          + f"; {card}", flush=True)

    kern["circuit"]["train"] = {"launches": counts_a["circuit"]}
    t_end = time.perf_counter()
    out["seconds"] = t_end - t_phase
    out["part_seconds"] = {"12a": t_b - t_phase, "12b": t_end - t_b}
    print(f"[12] training path: launches {total}; phase 12 took "
          f"{out['seconds']:.1f} s ({json.dumps(out['part_seconds'])})",
          flush=True)
    return total


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rel_rows(got, want):
    """Per row (leading axis) max|got - want| / max|want|, on the host."""
    g = got.float().cpu().reshape(got.shape[0], -1)
    w = want.float().cpu().reshape(want.shape[0], -1)
    return ((g - w).abs().amax(-1) / w.abs().amax(-1)).numpy()


def decode_cell(dev, mesh, seed: int, rows, fp32: bool = False) -> dict:
    """The dry run's cell (DIST_ARCH x DIST_SHAPE) whole on the card, made
    from ``seed``: params placed by the serve policy on ``mesh``, caches
    filled in place with normal bf16 values, tokens and positions (in
    [0, seq_len)) drawn; one ``make_serve_step`` step under ``mesh``.
    ``rows`` are held against a CPU run of the same rows from the caches
    as they were: ``rel`` has, per row, max|card - CPU| / max|CPU| of the
    logits and of the written k and v slots of every layer, and
    ``rel_fault`` that of the logits against the CPU run with every row's
    position one later.  With ``fp32`` the CPU run is also made in float32
    from the same values (``rel_fp32``), to read bf16's own error."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.config import SHAPES_BY_NAME
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.transformer import init_caches, init_lm
    from repro_torch.train.serve import make_serve_step

    cfg = get_config(DIST_ARCH)
    shape = SHAPES_BY_NAME[DIST_SHAPE]
    b, s = shape.global_batch, shape.seq_len
    gen = torch.Generator(dev).manual_seed(seed)
    params = init_lm(cfg, generator=gen, device=dev)
    params = shd.place(params, shd.param_shardings(params, mesh, "serve"))
    caches = init_caches(cfg, b, s, device=dev)
    for t in tree_leaves(caches):
        t.normal_(generator=gen)
    tok = torch.randint(cfg.vocab_size, (b,), generator=gen, device=dev)
    pos = torch.randint(s, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx = torch.tensor(rows, device=dev)
    before = tree_map(lambda t: t[:, idx].cpu(), caches)
    step = make_serve_step(cfg)
    with mesh:
        logits, _ = step(params, caches, tok, pos)
    torch.cuda.synchronize()
    got_logits = logits[idx].cpu()
    pos_rows = pos[idx].cpu()
    tok_rows = tok[idx].cpu()
    # each row's written k/v slot in every layer, (rows, L, G, hd)
    got_kv = {k: caches["attn"][k][:, idx, pos[idx].long()].transpose(
        0, 1).cpu() for k in ("k", "v")}
    at = torch.arange(len(rows))

    def cpu_rows(c, p, positions, ccfg):
        lg, c = make_serve_step(ccfg)(p, c, tok_rows, positions)
        return lg, {k: c["attn"][k][:, at, positions.long()].transpose(0, 1)
                    for k in ("k", "v")}

    def rel_to(want_logits, want_kv):
        out = {"logits": _rel_rows(got_logits, want_logits)}
        out.update({k: _rel_rows(got_kv[k], want_kv[k]) for k in got_kv})
        return out

    params_cpu = tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    want = cpu_rows(tree_map(torch.clone, before), params_cpu, pos_rows, cfg)
    cpu_s = time.perf_counter() - t0
    res = {"params": params, "caches": caches, "tok": tok, "pos": pos,
           "step": step, "logits_shape": tuple(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "pos_rows": pos_rows, "rel": rel_to(*want), "cpu_s": cpu_s}
    bad = cpu_rows(tree_map(torch.clone, before), params_cpu,
                   (pos_rows + 1) % s, cfg)
    res["rel_fault"] = _rel_rows(got_logits, bad[0])
    if fp32:
        f32 = lambda t: t.float()                             # noqa: E731
        res["rel_fp32"] = rel_to(*cpu_rows(
            tree_map(f32, before), tree_map(f32, params_cpu), pos_rows,
            cfg.replace(param_dtype="float32")))
    return res


def decode_bound_bytes(cfg, params, caches, pos) -> dict:
    """The bytes one decode step must move at least: for each row the
    cache slots 0..pos it attends to (the slot at pos is written, the
    others read), every weight the step reads once (the embedding table's
    rows of the batch's tokens only; not the vision stub's projection,
    which decode never reads) and the logits written.  ``full_cache_bytes``
    is the whole cache, which a masked read over every slot moves."""
    from repro_torch.models.params import tree_leaves

    def nbytes(t):
        return t.numel() * t.element_size()

    b = pos.shape[0]
    kv = caches["attn"]
    slot = sum(nbytes(kv[k]) // (kv[k].shape[1] * kv[k].shape[2])
               for k in ("k", "v"))            # one slot of one row, all layers
    cache_bytes = int((pos.long() + 1).sum()) * slot
    param_bytes = sum(nbytes(t) for t in tree_leaves(params))
    embed = params["embed"]["emb"]
    param_bytes -= nbytes(embed) - b * embed.shape[-1] * embed.element_size()
    if "frontend_proj" in params:
        param_bytes -= sum(nbytes(t) for t in tree_leaves(
            params["frontend_proj"]))
    logit_bytes = b * cfg.vocab_padded * 2
    return {"bytes": cache_bytes + param_bytes + logit_bytes,
            "cache_bytes": cache_bytes, "param_bytes": param_bytes,
            "logit_bytes": logit_bytes,
            "full_cache_bytes": sum(nbytes(t) for t in tree_leaves(caches))}


def _pipe_err(got, want, what: str, label: str = "13c") -> float:
    """``got`` within PIPE_TOL of ``want``: |got - want| <= PIPE_TOL
    (|want| + max|want|) elementwise; the largest error over max|want|."""
    g, w = got.detach().float(), want.detach().float()
    scale = w.abs().max()
    err = (g - w).abs()
    bad = err > PIPE_TOL * (w.abs() + scale)
    check(not bool(bad.any()), f"{label}: {what}: {int(bad.sum())} of "
          f"{w.numel()} entries off by more than {PIPE_TOL} (|want| + "
          f"max|want|); largest {float(err.max()):.3e}, max|want| "
          f"{float(scale):.3e}")
    return float(err.max() / scale)


def distributed_phase(dev, record: dict) -> None:
    """Phase 13: launch and distributed.  13a the dry run of the
    reference's cell on meta and its footprint on the host mesh; 13b that
    cell whole on the card, rows held against the CPU; 13c ``gpipe`` at
    full width against the sequential blocks; 13d the collectives over a
    one-rank NCCL group.  Launches none of K1-K6."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import (async_allreduce_scan,
                                                     pod_psum_compressed)
    from repro_torch.distributed.pipeline import gpipe, split_stages
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models.config import SHAPES_BY_NAME
    from repro_torch.models.params import flatten, tree_map, unflatten, unstack
    from repro_torch.models.transformer import block_forward, init_lm
    from repro_torch.train.compression import compressed_psum
    from repro_torch.train.train_loop import make_loss_fn

    card = record["card"]
    out = record["distributed"] = {}
    t_phase = time.perf_counter()

    # -- 13a: the dry run on meta ------------------------------------------
    phase("13a")
    cell = lower_cell(DIST_ARCH, DIST_SHAPE, multi_pod=True)
    arg_bytes = cell["memory"]["argument_bytes"]
    check(arg_bytes == DRYRUN_ARGUMENT_BYTES, f"13a: the dry run's "
          f"per-device argument bytes {arg_bytes} != {DRYRUN_ARGUMENT_BYTES}")
    mesh = make_host_mesh()
    check(mesh.size == 1 and mesh.devices[0].type == "cuda",
          f"13a: the host mesh is {mesh!r}, expected one card")
    host = lower_cell(DIST_ARCH, DIST_SHAPE, mesh=mesh)
    total = torch.cuda.get_device_properties(0).total_memory
    host_bytes = host["memory"]["argument_bytes"]
    check(host_bytes < total, f"13a: the cell's arguments take {host_bytes} "
          f"B on one device, more than the card's {total}")
    out["dryrun"] = {"cell": cell, "host": host, "total_memory": total}
    print(f"[13a] {DIST_ARCH} x {DIST_SHAPE} on 2x16x16 (meta, traced in "
          f"{cell['compile_s']} s): {arg_bytes} argument B and "
          f"{cell['flops_per_device']:.6e} FLOPs per device "
          f"({cell['n_devices']} devices); on the host mesh 1x1: "
          f"{host_bytes} argument B, {host['memory']['output_bytes']} output"
          f" B, {host['flops_per_device']:.6e} FLOPs, against the card's "
          f"{total} B")

    # -- 13b: the cell whole on the card -------------------------------------
    phase("13b")
    cfg = get_config(DIST_ARCH)
    b, s = SHAPES_BY_NAME[DIST_SHAPE].global_batch, SHAPES_BY_NAME[
        DIST_SHAPE].seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.hints.clear()              # 13a's trace on this mesh made some
    run = decode_cell(dev, mesh, DIST_SEED, DIST_ROWS)
    peak = torch.cuda.max_memory_allocated()
    params, caches, tok, pos = run["params"], run["caches"], run["tok"], run[
        "pos"]
    check(len(mesh.hints) == 4 * cfg.n_layers, f"13b: {len(mesh.hints)} "
          f"layout hints in the step, expected {4 * cfg.n_layers}")
    check(run["logits_shape"] == (b, cfg.vocab_padded) and run["finite"],
          f"13b: logits of shape {run['logits_shape']} or not finite")
    rel = run["rel"]
    for what, r in rel.items():
        check(r.max() <= DECODE_REL, f"13b: rows {DIST_ROWS} of the card's "
              f"{what} off the CPU's by {r.tolist()} of max|value|, "
              f"tolerance {DECODE_REL}")
    check(run["rel_fault"].min() > DECODE_REL, f"13b: a planted fault "
          f"(each row's position off by one) reads "
          f"{run['rel_fault'].tolist()} of max|logit|, within the tolerance "
          f"{DECODE_REL}")
    step = run["step"]
    step_ms = time_ms(lambda: step(params, caches, tok, pos), 5, warmup=1)
    prof = device_breakdown(lambda: step(params, caches, tok, pos))
    bound = decode_bound_bytes(cfg, params, caches, pos)
    bound_ms = bound["bytes"] / HBM_BYTES_PER_S * 1e3
    full_ms = bound["full_cache_bytes"] / HBM_BYTES_PER_S * 1e3
    check(peak >= host_bytes, f"13b: max_memory_allocated {peak} B below "
          f"the dry run's argument bytes {host_bytes}")
    out["decode"] = {
        "seed": DIST_SEED, "rows": list(DIST_ROWS),
        "positions": run["pos_rows"].tolist(),
        "rel_logits": rel["logits"].tolist(),
        "rel_k": rel["k"].tolist(), "rel_v": rel["v"].tolist(),
        "rel_fault": run["rel_fault"].tolist(), "tolerance": DECODE_REL,
        "step_ms": step_ms, "bound_ms": bound_ms, "bound_bytes": bound,
        "full_cache_read_ms": full_ms,
        "max_memory_allocated": peak, "dryrun_argument_bytes": host_bytes,
        "cpu_rows_s": run["cpu_s"], "profiled": prof, "card": card}
    print(f"[13b] {DIST_ARCH} decode, batch {b} against {s} cache slots x "
          f"{cfg.n_layers} layers ({bound['full_cache_bytes']} cache B): "
          f"rows {DIST_ROWS} at positions {run['pos_rows'].tolist()} within "
          f"{DECODE_REL} of the CPU's (logits {rel['logits'].max():.3e}, k "
          f"{rel['k'].max():.3e}, v {rel['v'].max():.3e} of max|value|; CPU "
          f"rows {run['cpu_s']:.1f} s); each row's position off by one reads "
          f"{run['rel_fault'].min():.3e} or more")
    print(f"[13b] step {step_ms:.3f} ms (events, 5 calls) against its bytes "
          f"bound {bound_ms:.3f} ms ({bound['bytes']} B at "
          f"{HBM_BYTES_PER_S:.3g} B/s: the {bound['cache_bytes']} cache B "
          f"that slots 0..pos of each row hold, the params the step reads "
          f"and the logits); reading the whole cache, as the masked einsum "
          f"does, would take {full_ms:.3f} ms; max_memory_allocated {peak} B,"
          f" dry run's arguments {host_bytes} B; {card}")
    top = list(prof["device_ms"].items())[:4]
    print(f"[13b] one profiled step: wall {prof['wall_ms']:.1f} ms, card "
          f"busy {prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}; " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in top))
    del params, caches, run, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13c: gpipe at full width, float32 ----------------------------------
    phase("13c")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "13c: TF32 matmuls are on")
    cfg32 = cfg.replace(param_dtype="float32")
    gen = torch.Generator(dev).manual_seed(14)
    blocks = init_lm(cfg32, generator=gen, device=dev)["blocks"]
    x = torch.randn((PIPE_BATCH, PIPE_SEQ, cfg.d_model), generator=gen,
                    device=dev)
    positions = torch.arange(PIPE_SEQ, dtype=torch.int32, device=dev)

    def stage_fn(stage, h):
        p = positions[None].expand(h.shape[0], PIPE_SEQ)
        for lp in unstack(stage):
            h = block_forward(lp, h, p, cfg32)[0]
        return h

    live = tree_map(lambda t: t.detach().requires_grad_(), blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_pipe = gpipe(stage_fn, split_stages(live, DIST_STAGES), x,
                   mesh=Mesh((DIST_STAGES,), ("pod",)), n_micro=PIPE_MICRO)
    g_pipe = torch.autograd.grad((h_pipe ** 2).sum(), flatten(live))
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    h_pipe = h_pipe.detach()
    t0 = time.perf_counter()
    h_seq = stage_fn(live, x)
    g_seq = torch.autograd.grad((h_seq ** 2).sum(), flatten(live))
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    err_h = _pipe_err(h_pipe, h_seq, "the pipeline's output")
    names = flatten(shd.tree_map_with_path(lambda k, _: ".".join(k), blocks))
    err_g = max(_pipe_err(a, w, f"grad of blocks.{name}")
                for a, w, name in zip(g_pipe, g_seq, names))
    out["gpipe"] = {"stages": DIST_STAGES, "n_micro": PIPE_MICRO,
                    "batch": PIPE_BATCH, "seq": PIPE_SEQ,
                    "err_out": err_h, "err_grads": err_g,
                    "tolerance": PIPE_TOL, "pipe_s": pipe_s, "seq_s": seq_s}
    print(f"[13c] gpipe: {cfg.n_layers} float32 blocks in {DIST_STAGES} "
          f"stages, {PIPE_BATCH} x {PIPE_SEQ} positions in {PIPE_MICRO} "
          f"microbatches: output and grads of sum(h**2) within {PIPE_TOL} of "
          f"the sequential loop (largest error / max|want|: output "
          f"{err_h:.3e}, grads {err_g:.3e}); forward+backward {pipe_s:.2f} s"
          f" piped ({PIPE_MICRO + DIST_STAGES - 1} ticks x {DIST_STAGES} "
          f"stages), {seq_s:.2f} s sequential")
    del blocks, live, h_pipe, h_seq, g_pipe, g_seq, x
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13d: collectives over a one-rank NCCL group -------------------------
    phase("13d")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        scfg = smoke_config("yi-6b").replace(param_dtype="float32")
        sp = init_lm(scfg, generator=torch.Generator(dev).manual_seed(15),
                     device=dev)
        batch = _train_batches(scfg, dev, 1, data=(16, 8, 0))[0]
        mbs = {k: v.reshape(4, v.shape[0] // 4, *v.shape[1:])
               for k, v in batch.items()}
        loss_fn = make_loss_fn(scfg)

        def grad_fn(p, mb):
            lv = tree_map(lambda t: t.detach().requires_grad_(), p)
            loss, _ = loss_fn(lv, mb)
            return unflatten(lv, torch.autograd.grad(
                loss, flatten(lv), materialize_grads=True))

        torch.use_deterministic_algorithms(True)
        try:
            got = async_allreduce_scan(grad_fn, sp, mbs)
            plain = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32),
                             sp)
            for i in range(4):
                tree_map(lambda a, g: a.add_(g), plain,
                         grad_fn(sp, {k: v[i] for k, v in mbs.items()}))
        finally:
            torch.use_deterministic_algorithms(False)
        same = all(torch.equal(a, b) for a, b in zip(flatten(got),
                                                     flatten(plain)))
        check(same, "13d: async_allreduce_scan over one NCCL rank != plain "
              "accumulation of the same 4 microbatches")
        xs = torch.randn(1 << 20, generator=torch.Generator(dev)
                         .manual_seed(16), device=dev)
        check(pod_psum_compressed(mesh, xs) is xs,
              "13d: pod_psum_compressed without a pod axis is not x itself")
        pod = Mesh((1, 1, 1), ("pod", "data", "model"), [dev])
        check(torch.equal(pod_psum_compressed(pod, xs), compressed_psum(xs)),
              "13d: pod_psum_compressed with pod=1 != compressed_psum")
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    out["collectives"] = {"grad_leaves": len(flatten(got)), "equal": same}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[13d] one-rank NCCL group: async_allreduce_scan of "
          f"{len(flatten(got))} smoke yi-6b gradient leaves over 4 "
          f"microbatches == plain accumulation bit for bit; "
          f"pod_psum_compressed is x without a pod axis and == "
          f"compressed_psum with pod=1")
    print(f"[13] phase 13 took {out['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: the examples (examples_torch/) on the card
# ---------------------------------------------------------------------------

def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(mod, argv, card: bool) -> tuple:
    """``mod.main(argv)`` with its output captured: (dict, output, wall
    s)."""
    import contextlib
    import io

    import torch
    from repro_torch.core.control_unit import TABLE_CACHE
    # every run starts from an empty command-table cache: the telemetry
    # example's span tree shows its misses
    TABLE_CACHE.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        out = mod.main(argv)
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, buf.getvalue(), wall


def _same_values(a, b) -> bool:
    """``a == b`` through dicts, lists, tuples and numpy arrays."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_values(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_values(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    return a == b


def _example_decode(name, got, want, rel) -> tuple:
    """Step by step, the card's logits within ``rel`` of each row's
    max|logit| of the CPU run's (``rel`` None: within ``LM_TOL``, rtol
    and atol) and its greedy tokens ``==`` at every row whose CPU margin
    exceeds twice that.  (largest error over its bound, True if every
    step's tokens agree; past a token taken at a smaller margin the two
    decode different prefixes and are compared no further)."""
    worst = 0.0
    for s, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        check(g.shape == w.shape, f"{name}: step {s} logits {g.shape} != "
              f"{w.shape}")
        err = np.abs(g - w)
        top = np.abs(w).max(-1, keepdims=True)
        bnd = rel * top if rel is not None else LM_TOL + LM_TOL * np.abs(w)
        check(bool((err <= bnd).all()), f"{name}: step {s} logits differ "
              f"from the CPU run's by {float(err.max()):.3e}, more than "
              f"{'%g of max|logit|' % rel if rel else 'rtol = atol = %g' % LM_TOL}")
        worst = max(worst, float((err / bnd).max()))
        top2 = np.sort(w, -1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        thr = 2 * (rel * top[..., 0] if rel is not None else LM_TOL)
        differ = np.argmax(g, -1) != np.argmax(w, -1)
        check(not bool((differ & (margin > thr)).any()),
              f"{name}: step {s} greedy tokens differ at a CPU margin above "
              f"twice the tolerance")
        if differ.any():
            return worst, False
    check(len(got) == len(want), f"{name}: {len(got)} decode steps on the "
          f"card, {len(want)} on the CPU")
    return worst, True


def _fault_drawn(name, card: dict, cpu: dict) -> bool:
    """A faulty dispatch's flip-drawn fields, card against the CPU run:
    both exact after vote and retry, the same redispatches, remaps and
    host fallbacks, injected flips within the Poisson bound |a - b| <=
    4 sqrt(a + b) + 4, at most 3 retries.  (Philox draws the same bits on
    both, so they are expected equal; printed, not required.)"""
    check(card["exact"] and cpu["exact"],
          f"{name}: a faulty dispatch was not exact after vote and retry")
    fc, fp = card["faults"], cpu["faults"]
    check(fc.keys() == fp.keys() and all(
        fc[k] == fp[k] for k in ("redispatches", "remapped",
                                 "host_fallbacks")),
          f"{name}: fault stats {fc} against the CPU's {fp}")
    a, b = fc["injected"], fp["injected"]
    check(abs(a - b) <= 4 * np.sqrt(a + b) + 4 and fc["retries"] <= 3,
          f"{name}: {a} flips injected on the card, {b} on the CPU, or more "
          f"than 3 retries ({fc['retries']})")
    return _same_values(card, cpu)


def examples_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 14: every ``examples_torch/`` file in-process on the card at
    the reference example's sizes (``train_lm.py`` at ``TRAIN_LM_STEPS``
    steps, from a directory under ``build/``), its kernel launches
    counted; then its twin run (a repeat under ``_Twins``: every launch
    held against the plain version on host copies of its inputs, one
    twin per launch of the counted run); then its returned dict held against the same
    example run with ``--device cpu``.  Returns the launches of every
    example together."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels import build
    work = ROOT / "build" / "examples"
    if work.exists():
        import shutil
        shutil.rmtree(work)
    work.mkdir(parents=True)
    spec = importlib.util.spec_from_file_location(
        "check_trace", ROOT / "scripts" / "check_trace.py")
    check_trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_trace)

    total = {k: 0 for k in build.LAUNCHES}
    errs = {k: [] for k in EXAMPLE_KERNELS_ALL}
    walls, out = {}, {}
    cwd = os.getcwd()
    for name, kernels in EXAMPLE_KERNELS.items():
        mod = _load_example(name)
        argv = ["--device", "cuda"]
        if name == "train_lm":
            argv += ["--steps", str(TRAIN_LM_STEPS)]
        traces = []
        if name == "telemetry_quickstart":
            # the example exports to /tmp as its reference does; here its
            # two files go under build/examples
            wct, wjl = obs.write_chrome_trace, obs.write_jsonl

            def chrome(path, *a, **k):
                traces.append(wct(str(work / Path(path).name), *a, **k))
                return traces[-1]

            obs.write_chrome_trace = chrome
            obs.write_jsonl = lambda path, *a, **k: wjl(
                str(work / Path(path).name), *a, **k)
        try:
            os.chdir(work)
            build.reset_launches()
            got, text, wall = _run_example(mod, argv, card=True)
            counts = dict(build.LAUNCHES)
            twin_s = None
            if any(counts[k] for k in EXAMPLE_KERNELS_ALL):
                t0 = time.perf_counter()
                with _Twins(host=True) as tw:
                    _run_example(mod, argv, card=True)
                twin_s = time.perf_counter() - t0
                for k in EXAMPLE_KERNELS_ALL:
                    check(len(tw.errs[k]) == counts[k],
                          f"{name}: {len(tw.errs[k])} {k} launches in the "
                          f"twin run, {counts[k]} in the counted run")
                    errs[k] += tw.errs[k]
            want = cpu_text = cpu_wall = None
            if name != "train_lm":
                build.reset_launches()
                want, cpu_text, cpu_wall = _run_example(
                    mod, ["--device", "cpu"], card=False)
                check(not any(build.LAUNCHES.values()),
                      f"{name}: the CPU run launched a kernel")
        finally:
            os.chdir(cwd)
            if name == "telemetry_quickstart":
                obs.write_chrome_trace, obs.write_jsonl = wct, wjl
        for k in total:
            total[k] += counts[k]
        # every kernel the example runs was launched, and K4 never
        for k in kernels:
            check(counts[k] > 0, f"{name}: kernel {k} was not launched on "
                  f"the card ({counts})")
        check(counts["popmatmul"] == 0, f"{name}: launched K4 ({counts})")
        res = {"launches": counts, "card_s": wall, "twin_s": twin_s,
               "cpu_s": cpu_wall, "output": text}
        if name in ("serve_llm", "chip_offload_quickstart"):
            res["logits_err"], agree = _example_decode(
                name, got["lm"]["logits"], want["lm"]["logits"],
                LM_BF16_REL)
            res["tokens_agree"] = agree
            if agree:
                check(got["lm"]["tokens"] == want["lm"]["tokens"],
                      f"{name}: tokens differ though every step agreed")
            elif name == "chip_offload_quickstart":
                got["modeled"].pop("offload"), want["modeled"].pop("offload")
        elif name == "pum_offload_demo":
            res["logits_err"], _ = _example_decode(
                name, [got["lm"]["logits"]], [want["lm"]["logits"]], None)
        elif name == "train_lm":
            losses = got["lm"]["losses"]
            check(len(losses) == TRAIN_LM_STEPS and np.isfinite(losses).all(),
                  f"train_lm: losses {losses}")
            res["losses"] = losses
        if name == "fault_tolerance_quickstart":
            res["drawn_equal"] = all(
                _fault_drawn(name, got["drawn"][k], want["drawn"][k])
                for k in ("bank", "chip"))
        if want is not None:
            for key in ("results", "modeled"):
                check(_same_values(got.get(key), want.get(key)),
                      f"{name}: the card's {key} differ from the CPU run's")
            res["lines"] = [len(text.splitlines()),
                            len(cpu_text.splitlines())]
        if name == "telemetry_quickstart":
            # one trace each from the card's run, its twin and the CPU's
            errors = [check_trace.check_trace(t) for t in traces]
            check(len(traces) == 3 and not any(errors), f"{name}: "
                  f"{len(traces)} Chrome traces written, check_trace finds "
                  f"{[e[:5] for e in errors]}")
        walls[name] = (wall, twin_s, cpu_wall)
        out[name] = res
        del got, want
        print(f"[14] {name}: card {wall:.2f} s"
              + (f", twin {twin_s:.2f} s" if twin_s is not None else "")
              + (f", CPU {cpu_wall:.2f} s" if cpu_wall is not None else "")
              + f"; launches { {k: v for k, v in counts.items() if v} }"
              + ("".join(f"; {k} {v}" for k, v in res.items()
                         if k in ("logits_err", "tokens_agree",
                                  "drawn_equal", "losses"))),
              flush=True)
        torch.cuda.empty_cache()

    for k in EXAMPLE_KERNELS_ALL:
        if not total[k]:
            continue
        check(len(errs[k]) == total[k] and max(errs[k]) == 0,
              f"{k}: the examples' launches disagree with the plain version "
              f"({len(errs[k])} compared of {total[k]}, largest error "
              f"{max(errs[k], default=None)})")
        _agree(kern[k]["agreement"], "examples", total[k], errs[k])
        print(f"[14] {k}: {total[k]} launches on the examples' path, each "
              f"twin against the plain version on its inputs: largest "
              f"error {max(errs[k])}", flush=True)
    print(f"[14] example walls, card / twin run / CPU s ({record['card']}): "
          + ", ".join(f"{n} " + " / ".join(
              "-" if t is None else f"{t:.2f}" for t in ts)
              for n, ts in walls.items()), flush=True)
    record["examples"] = out
    return total


class _SlabTwins:
    """Within ``with``: every K5 and K6 launch made through the port's
    wrappers keeps host copies of its inputs (tables cut at the longest
    real command count, whose NOPs after it change nothing) and outputs,
    as :func:`_stacked_plain` members, keyed by state shape (and K6's
    flip threshold).  The copies are read on the launch's own stream."""

    def __init__(self):
        self.k5, self.k6 = [], []

    def __enter__(self):
        from repro_torch.core import control_unit as cu
        self.cu = cu
        self.made = k5, k6 = cu._replay_kernel, cu._faulty_replay_kernel

        def cut(states, tables, schedule):
            per_unit = tables if tables.dim() == 3 else tables.expand(
                states.shape[0], *tables.shape)
            return per_unit[:, :int(schedule[0].max())].cpu()

        def replay(states, tables, schedule):
            out = k5(states, tables, schedule)
            self.k5.append((tuple(states.shape[1:]),
                            (states.cpu(), cut(states, tables, schedule)),
                            (out.cpu(),)))
            return out

        def faulty(states, tables, schedule, keys, s0, s1, dead, thr):
            outs = k6(states, tables, schedule, keys, s0, s1, dead, thr)
            self.k6.append((tuple(states.shape[1:]) + (thr,),
                            (states.cpu(), cut(states, tables, schedule),
                             keys.cpu(), s0.cpu(), s1.cpu(), dead.cpu()),
                            tuple(o.cpu() for o in outs)))
            return outs

        cu._replay_kernel, cu._faulty_replay_kernel = replay, faulty
        return self

    def __exit__(self, *exc):
        self.cu._replay_kernel, self.cu._faulty_replay_kernel = self.made

    def hold(self, dev, label: str) -> tuple:
        """Every kept launch against the plain version on the card, those
        of one key in one call: (K5 errors, K6 errors, K5's and K6's
        plain s)."""
        from repro_torch.core.control_unit import (faulty_replay_plain,
                                                   replay_plain)
        e5, p5 = _stacked_plain(self.k5, lambda key, st, tb: (
            replay_plain(st.to(dev), tb.to(dev)).cpu(),))
        e6, p6 = _stacked_plain(self.k6, lambda key, st, tb, *rest: tuple(
            o.cpu() for o in faulty_replay_plain(
                st.to(dev), tb.to(dev), *(r.to(dev) for r in rest),
                key[2] / 2 ** 32)))
        check(max(e5 + e6, default=0) == 0,
              f"{label}: a slab launch disagrees with the plain version "
              f"(K5 {e5}, K6 {e6})")
        return e5, e6, sum(p5), sum(p6)


def _split_mesh(sizes, axes) -> tuple:
    """A mesh of ``sizes`` over the visible cards where there are enough,
    else over ``cuda:0`` repeated: (mesh, which)."""
    import torch

    from repro_torch.launch.mesh import Mesh
    n = int(np.prod(sizes))
    if torch.cuda.device_count() >= n:
        return (Mesh(sizes, axes, [torch.device("cuda", i)
                                   for i in range(n)]),
                f"{n} visible cards")
    return (Mesh(sizes, axes, [torch.device("cuda", 0)] * n),
            f"cuda:0 repeated {n} times")


def _split_run(make, queue_fn, fault: bool = False) -> dict:
    """One dispatch on a fresh engine ``make()`` of ``queue_fn()`` (made
    before the counters are set to 0), counted and timed; the faulty
    executor's attempts keep their flip counts.  Returns the engine,
    flattened results, modeled stats, launches, attempts, table-cache
    misses and host wall."""
    import torch

    from repro_torch.core.control_unit import TABLE_CACHE
    from repro_torch.kernels import build
    eng = make()
    queue = queue_fn()
    flips: list = []
    if fault:
        run, ex = eng._faulty_executor.run, eng._faulty_executor

        def rec(*args):
            out = run(*args)
            flips.append(out[1].cpu().numpy())
            return out

        eng._faulty_executor = dataclasses.replace(ex, run=rec)
    misses = TABLE_CACHE.stats()["misses"]
    build.reset_launches()
    t0 = time.perf_counter()
    res = eng.dispatch(queue)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    stats = eng.stats.as_dict()
    return {"engine": eng, "results": _flat(res), "wall_s": wall,
            "launches": counts, "flips": flips,
            "misses": TABLE_CACHE.stats()["misses"] - misses,
            "modeled": {k: v for k, v in stats.items()
                        if k not in MEASURED_STATS}}


def _same_run(label: str, got: dict, want: dict, fault: bool = False):
    check(len(got["results"]) == len(want["results"]) and all(
        np.array_equal(g, e) for g, e in zip(got["results"],
                                             want["results"])),
          f"{label}: results differ from the unsplit run's")
    check(got["modeled"] == want["modeled"],
          f"{label}: modeled stats differ from the unsplit run's: "
          + str({k: (v, want["modeled"].get(k))
                 for k, v in got["modeled"].items()
                 if v != want["modeled"].get(k)}))
    if fault:
        check(len(got["flips"]) == len(want["flips"]) and all(
            np.array_equal(g, e) for g, e in zip(got["flips"],
                                                 want["flips"])),
              f"{label}: flip counts of an attempt differ from the unsplit "
              f"run's ({len(got['flips'])} and {len(want['flips'])} "
              f"attempts)")


def split_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 15: the chip, channel and rank split across a device mesh,
    and the chip's and a channel's fault wrappers split, each against
    the unsplit executor on the card; twins of the split runs hold every
    slab launch against the plain version.  Returns the split runs'
    launches."""
    import torch

    from repro_torch.core import bank as bank_mod
    from repro_torch.core.channel import SimdramChannel
    from repro_torch.core.chip import SimdramChip
    from repro_torch.core.fault import FaultModel
    from repro_torch.core.ops_library import get_op
    from repro_torch.core.rank import SimdramRank
    from repro_torch.core.timing import DDR4
    from repro_torch.kernels import build

    lanes = DDR4.columns_per_subarray
    banks, subs = DDR4.n_banks, DDR4.subarrays_per_bank
    total = {k: 0 for k in build.LAUNCHES}
    rows: dict = {}
    twins = _SlabTwins()
    twinned = {"replay": 0, "faulty_replay": 0}

    def counted(label, run, positions, n_rounds, kernel):
        got = run["launches"]
        check(got[kernel] == n_rounds * positions
              and all(v == 0 for k, v in got.items() if k != kernel),
              f"{label}: launches {got} for {n_rounds} rounds (attempts) "
              f"on {positions} positions")
        for k, v in got.items():
            total[k] += v

    def twin(label, make, queue_fn, n_launches, kernel):
        """The split run again under ``twins``, which keeps as many slab
        launches as the counted run's (held against the plain version at
        the end of the phase, every state shape in one call)."""
        before = len(twins.k5), len(twins.k6)
        with twins:
            again = _split_run(make, queue_fn, fault=kernel != "replay")
        n5, n6 = len(twins.k5) - before[0], len(twins.k6) - before[1]
        check((n5, n6) == ((n_launches, 0) if kernel == "replay"
                           else (0, n_launches)),
              f"{label}: {n5} K5 and {n6} K6 launches in the twin run, "
              f"{n_launches} {kernel} launches in the counted run")
        twinned[kernel] += n_launches
        return again

    # the chip at full width over data = 4 and 16
    mix = lambda: mix_queue(bank_mod, get_op, lanes,  # noqa: E731
                            n_instrs=2 * banks * subs, widths=(8,))
    chain = lambda: chain_queue(bank_mod, lanes, dev)[0]  # noqa: E731

    def chip_queue():
        return mix() + chain()

    whole = lambda: SimdramChip(n_banks=banks,  # noqa: E731
                                n_subarrays=subs, device=dev)
    _split_run(whole, chip_queue)                  # warm the table cache
    base = _split_run(whole, chip_queue)
    n_rounds = base["engine"].stats.rounds
    chip = {"unsplit_wall_s": base["wall_s"], "rounds": n_rounds,
            "unsplit_repeat_misses": base["misses"]}
    for n in SPLIT_CHIP_POSITIONS:
        mesh, which = _split_mesh((n,), ("data",))

        def make(mesh=mesh):
            return SimdramChip(n_banks=banks, n_subarrays=subs, device=dev,
                               mesh=mesh)

        got = _split_run(make, chip_queue)
        label = f"chip over data = {n}"
        check(got["engine"].executor.sharded, f"{label}: not split")
        _same_run(label, got, base)
        counted(label, got, n, n_rounds, "replay")
        again = twin(label, make, chip_queue, got["launches"]["replay"],
                     "replay")
        _same_run(f"{label}, twin run", again, base)
        check(again["misses"] <= base["misses"],
              f"{label}: the repeated split dispatch missed the table cache "
              f"{again['misses']} times, the unsplit repeat "
              f"{base['misses']}")
        chip[f"data={n}"] = {"mesh": which, "wall_s": got["wall_s"],
                             "twin_wall_s": again["wall_s"],
                             "repeat_misses": again["misses"],
                             "launches": got["launches"]["replay"]}
        print(f"[15] {label} ({which}): {n_rounds} rounds, "
              f"{got['launches']['replay']} K5 launches, results and "
              f"modeled stats == the unsplit run; wall {got['wall_s']:.3f} "
              f"s against unsplit {base['wall_s']:.3f} s; repeat misses "
              f"{again['misses']} (unsplit {base['misses']})", flush=True)
    rows["chip"] = chip

    # the channel (phase 7's 8 chips) over (channel, data) = (2, 4)
    n_chips = SPLIT_CHANNEL_CHIPS
    units = n_chips * banks * subs
    ch_queue = lambda: mix_queue(bank_mod, get_op, lanes,  # noqa: E731
                                 n_instrs=units, widths=(8,))
    mesh, which = _split_mesh(SPLIT_CHANNEL_MESH, ("channel", "data"))
    positions = int(np.prod(SPLIT_CHANNEL_MESH))

    def channel(mesh=None, fault=None, chips=n_chips):
        return lambda: SimdramChannel(
            n_chips=chips, n_banks=banks, n_subarrays=subs, device=dev,
            mesh=mesh, use_shard_map=None if mesh else False, fault=fault)

    base = _split_run(channel(), ch_queue)
    got = _split_run(channel(mesh), ch_queue)
    label = f"channel of {n_chips} chips over (channel, data) = " \
        f"{SPLIT_CHANNEL_MESH}"
    _same_run(label, got, base)
    n_rounds = base["engine"].stats.super_rounds
    counted(label, got, positions, n_rounds, "replay")
    twin(label, channel(mesh), ch_queue, got["launches"]["replay"],
         "replay")
    rows["channel"] = {"mesh": which, "rounds": n_rounds,
                       "wall_s": got["wall_s"],
                       "unsplit_wall_s": base["wall_s"],
                       "launches": got["launches"]["replay"]}
    print(f"[15] {label} ({which}): {n_rounds} super-rounds, "
          f"{got['launches']['replay']} K5 launches, results and modeled "
          f"stats == the unsplit run; wall {got['wall_s']:.3f} s against "
          f"unsplit {base['wall_s']:.3f} s", flush=True)

    # the rank at the reference's subprocess geometry over (2, 2, 2), and
    # on the CPU
    rng = np.random.default_rng(0)

    def rank_queue():
        queue = []
        for op in ("addition", "multiplication", "greater", "xor_red"):
            spec = get_op(op, 8)
            queue.append(bank_mod.BbopInstr(op, tuple(
                rng.integers(0, 1 << w, 64).astype(np.uint64)
                for w in spec.operand_bits), 8))
        queue.append(bank_mod.BbopInstr("relu", (bank_mod.Ref(0),), 8))
        return queue

    mesh, which = _split_mesh(SPLIT_RANK_MESH, ("rank", "channel", "data"))
    runs = {}
    for key, kw in (("split", {"mesh": mesh}),
                    ("unsplit", {"use_shard_map": False}),
                    ("cpu", {"device": "cpu", "use_shard_map": False})):
        rng = np.random.default_rng(0)
        runs[key] = _split_run(lambda kw=kw: SimdramRank(
            **{"device": dev, **SPLIT_RANK, **kw}), rank_queue)
    label = f"rank {SPLIT_RANK} over (rank, channel, data) = " \
        f"{SPLIT_RANK_MESH}"
    _same_run(label, runs["split"], runs["unsplit"])
    _same_run(f"{label} against the CPU", runs["split"], runs["cpu"])
    n_rounds = runs["unsplit"]["engine"].stats.super_rounds
    positions = int(np.prod(SPLIT_RANK_MESH))
    counted(label, runs["split"], positions, n_rounds, "replay")
    rng = np.random.default_rng(0)
    twin(label, lambda: SimdramRank(device=dev, mesh=mesh, **SPLIT_RANK),
         rank_queue, runs["split"]["launches"]["replay"], "replay")
    rows["rank"] = {"mesh": which, "rounds": n_rounds,
                    "wall_s": runs["split"]["wall_s"],
                    "unsplit_wall_s": runs["unsplit"]["wall_s"],
                    "cpu_wall_s": runs["cpu"]["wall_s"],
                    "launches": runs["split"]["launches"]["replay"]}
    print(f"[15] {label} ({which}): {n_rounds} rounds, "
          f"{runs['split']['launches']['replay']} K5 launches, results and "
          f"modeled stats == the unsplit run and the CPU's", flush=True)

    # the fault wrappers: the chip over data = 4, a 2-chip channel over
    # (channel, data) = (2, 4)
    chip_mesh, chip_which = _split_mesh((SPLIT_CHIP_POSITIONS[0],),
                                        ("data",))
    ch_mesh, ch_which = _split_mesh(SPLIT_CHANNEL_MESH, ("channel", "data"))
    for tier, n_units, mesh, which in (
            ("chip", banks * subs, chip_mesh, chip_which),
            ("channel", SPLIT_FAULT_CHIPS * banks * subs, ch_mesh,
             ch_which)):
        positions = mesh.size
        for name, fault_lanes, model in SPLIT_FAULT_MODELS:
            queue = lambda: mix_queue(  # noqa: E731
                bank_mod, get_op, fault_lanes, n_instrs=n_units,
                widths=(8,))

            def make(mesh=None, tier=tier, model=model):
                if tier == "chip":
                    return lambda: SimdramChip(
                        n_banks=banks, n_subarrays=subs, device=dev,
                        mesh=mesh, use_shard_map=None if mesh else False,
                        fault=FaultModel(**model))
                return channel(mesh, FaultModel(**model), SPLIT_FAULT_CHIPS)

            base = _split_run(make(), queue, fault=True)
            got = _split_run(make(mesh), queue, fault=True)
            label = f"faulty {tier} ({name}) over {dict(mesh.shape)}"
            _same_run(label, got, base, fault=True)
            fs, want = (got["engine"].stats.faults.as_dict(),
                        base["engine"].stats.faults.as_dict())
            check(fs == want, f"{label}: FaultStats {fs} against the "
                  f"unsplit run's {want}")
            counted(label, got, positions, len(got["flips"]),
                    "faulty_replay")
            twin(label, make(mesh), queue,
                 got["launches"]["faulty_replay"], "faulty_replay")
            rows[f"faulty_{tier}_{name}"] = {
                "mesh": which, "attempts": len(got["flips"]),
                "launches": got["launches"]["faulty_replay"],
                "wall_s": got["wall_s"], "unsplit_wall_s": base["wall_s"],
                "faults": fs}
            print(f"[15] {label} ({which}): {len(got['flips'])} attempts, "
                  f"{got['launches']['faulty_replay']} K6 launches; "
                  f"results, modeled stats, flip counts and FaultStats == "
                  f"the unsplit run {json.dumps(fs)}; wall "
                  f"{got['wall_s']:.3f} s against unsplit "
                  f"{base['wall_s']:.3f} s", flush=True)

    e5, e6, plain5, plain6 = twins.hold(dev, "the split runs' twins")
    check((len(e5), len(e6)) == (twinned["replay"],
                                 twinned["faulty_replay"]),
          f"{len(e5)} K5 and {len(e6)} K6 twins held, {twinned} launched")
    _agree(kern["replay"]["agreement"], "split", total["replay"], e5)
    _agree(kern["faulty_replay"]["agreement"], "split faults",
           total["faulty_replay"], e6)
    kern["replay"]["split"] = {k: v for k, v in rows.items()
                               if not k.startswith("faulty")}
    kern["faulty_replay"]["split"] = {k: v for k, v in rows.items()
                                      if k.startswith("faulty")}
    walls = {k: (v.get("wall_s", v.get("data=4", {}).get("wall_s")),
                 v.get("unsplit_wall_s"))
             for k, v in rows.items()}
    print(f"[15] split / unsplit walls s ({record['card']}): " + ", ".join(
        f"{k} " + " / ".join("-" if t is None else f"{t:.3f}" for t in ts)
        for k, ts in walls.items()) + "; the chip over data = 16 "
        f"{rows['chip']['data=16']['wall_s']:.3f}", flush=True)
    print(f"[15] every slab launch of the twin runs equals the plain "
          f"version: K5 {len(e5)} of {total['replay']}, K6 {len(e6)} of "
          f"{total['faulty_replay']} (plain K5 {plain5:.2f} s, K6 "
          f"{plain6:.2f} s, each state shape in one call)", flush=True)
    rows["plain_s"] = {"replay": plain5, "faulty_replay": plain6}
    record["split"] = rows
    return total


# ---------------------------------------------------------------------------
# phase 16: the LM side over a device mesh
# ---------------------------------------------------------------------------

def moe_ep_served(dev, cfg, params, mesh, prompts, offload=None,
                  drop_rank=None) -> dict:
    """``prompts`` served greedily by a ``Server`` of ``cfg`` with
    ``moe_impl="ep"`` under ``mesh`` (through ``offload``), and in
    lockstep the grouped decode (``moe_impl="grouped"``, no mesh) of the
    same tokens on caches of its own, both under deterministic
    algorithms (the scatter-adds of the dispatch then sum each slot's
    contributions in float32, in a fixed order, so a reading repeats).
    Returns per step the active rows' logits of both (float32, host),
    the tokens and the server's steps.  ``drop_rank`` plants a fault:
    that ``model`` rank's partial output is dropped before the psum."""
    import contextvars

    import torch
    import torch.utils.deterministic as deterministic

    from repro_torch.models import moe
    from repro_torch.models.transformer import init_caches
    from repro_torch.train.serve import Request, Server, make_serve_step

    slots = len(prompts)
    server = Server(cfg.replace(moe_impl="ep"), params, batch_slots=slots,
                    max_len=MESH_LM_MAX_LEN, pum_offload=offload, device=dev)
    grouped = cfg.replace(moe_impl="grouped")
    g_step = make_serve_step(grouped)
    g_caches = init_caches(grouped, slots, MESH_LM_MAX_LEN, dev)
    ep_step, ep_rows, g_rows, ms = server.step_fn, [], [], []

    def lockstep(p, caches, token, pos):
        t0 = time.perf_counter()
        logits, caches = ep_step(p, caches, token, pos)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # the grouped twin in a fresh context, where no mesh is ambient
        g_logits, _ = contextvars.Context().run(g_step, p, g_caches, token,
                                                pos)
        torch.cuda.synchronize()
        ms.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        act = [i for i, r in enumerate(server.slots) if r is not None]
        ep_rows.append(logits[act].float().cpu())
        g_rows.append(g_logits[act].float().cpu())
        return logits, caches

    server.step_fn = lockstep
    local = moe._grouped_local
    if drop_rank is not None:
        def dropped(p, xt, *, e_lo, e_loc, **kw):
            out, aux = local(p, xt, e_lo=e_lo, e_loc=e_loc, **kw)
            if e_loc < cfg.n_experts and e_lo == drop_rank * e_loc:
                out = torch.zeros_like(out)
            return out, aux
        moe._grouped_local = dropped
    reqs = [Request(prompt=list(p), max_new=MESH_LM_MAX_NEW)
            for p in prompts]
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    fill = deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    deterministic.fill_uninitialized_memory = False
    try:
        with mesh:
            server.run(max_steps=64)
        torch.cuda.synchronize()
    finally:
        moe._grouped_local = local
        torch.use_deterministic_algorithms(False)
        deterministic.fill_uninitialized_memory = fill
    check(all(r.done for r in reqs), f"16a: {sum(not r.done for r in reqs)} "
          f"of {len(reqs)} requests did not complete in 64 steps")
    return {"ep": ep_rows, "grouped": g_rows, "tokens": [r.out for r in reqs],
            "steps": len(ep_rows), "wall_s": time.perf_counter() - t0,
            "step_ms": ms}


def moe_ep_rel(run) -> np.ndarray:
    """Each served row's max|ep - grouped| over its grouped max|logit|,
    every step's rows in order."""
    return np.concatenate([((e - g).abs().amax(-1) / g.abs().amax(-1))
                           .numpy() for e, g in zip(run["ep"],
                                                    run["grouped"])])


def mesh_lm_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 16: the LM side over a device mesh, one program a position in
    one process.  16a granite-moe-1b-a400m at full width served with
    ``moe_impl="ep"`` over a (1, 4) mesh through PumServeOffload (K5),
    against the grouped decode; 16b the elastic drill, sharded steps on
    (4, 2), ``reshard_restore`` onto (2, 2), against the unsharded run;
    16c ``gpipe`` with one stage a position, each on its own stream.
    Returns 16a's launches."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.chip import SimdramChip
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import gpipe, split_stages
    from repro_torch.kernels import build
    from repro_torch.models.params import flatten, tree_leaves, tree_map, unstack
    from repro_torch.models.transformer import block_forward, init_lm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.fault_tolerance import recovery_plan
    from repro_torch.train.serve import PumServeOffload
    from repro_torch.train.train_loop import make_train_step

    card = record["card"]
    out = record["mesh_lm"] = {}
    t_phase = time.perf_counter()

    # -- 16a: granite-moe-1b-a400m at full width, experts over (1, 4) -------
    phase("16a")
    cfg = get_config(MESH_LM_ARCH).replace(n_layers=MESH_LM_LAYERS)
    params = init_lm(cfg, generator=torch.Generator(dev).manual_seed(
        MESH_LM_SEED), device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    # param_count() counts the published vocabulary, the init its padding
    pad = (cfg.vocab_padded - cfg.vocab_size) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    check(n_params == cfg.param_count() + pad, f"16a: {n_params} "
          f"parameters, param_count() {cfg.param_count()} + {pad} of the "
          f"padded vocabulary")
    mesh, where = _split_mesh(MESH_LM_MESH, ("data", "model"))
    rng = np.random.default_rng(MESH_LM_SEED)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, size=n)]
               for n in MESH_LM_PROMPTS]
    chip = SimdramChip(n_banks=4, n_subarrays=2, device=dev)
    offload = PumServeOffload(chip=chip)
    rounds = []
    executor = chip.executor
    # a warm-up run builds the chip's tables and the model's kernels; the
    # counted run records its rounds for the twins
    moe_ep_served(dev, cfg, params, mesh, prompts[:1], offload)
    chip.executor = _recording(executor, rounds)
    r0 = chip.stats.rounds
    build.reset_launches()
    run = moe_ep_served(dev, cfg, params, mesh, prompts, offload)
    counts = dict(build.LAUNCHES)
    n_rounds = chip.stats.rounds - r0
    chip.executor = executor
    check(counts["replay"] == n_rounds > 0 and all(
        v == 0 for k, v in counts.items() if k != "replay"),
        f"16a: launches {counts} for {n_rounds} chip rounds, expected one K5 "
        f"launch a round and nothing else")
    check(len(rounds) == counts["replay"], f"16a: {len(rounds)} recorded "
          f"rounds, {counts['replay']} K5 launches")
    errs_k5, plain_s = _k5_stacked(dev, rounds)
    del rounds
    _agree(kern["replay"]["agreement"], "mesh lm", counts["replay"], errs_k5)
    rel = moe_ep_rel(run)
    check(bool(np.isfinite(rel).all()) and float(rel.max()) <= MOE_EP_REL,
          f"16a: the ep run's logits off the grouped run's by "
          f"{float(rel.max()):.4e} of max|logit| (tolerance {MOE_EP_REL})")
    held = _lm_tokens(torch.cat(run["ep"]), torch.cat(run["grouped"]),
                      MOE_EP_REL, "16a ep against grouped", relative=True)
    fault = moe_ep_served(dev, cfg, params, mesh, prompts[:2], offload,
                          drop_rank=MESH_LM_DROP_RANK)
    rel_fault = moe_ep_rel(fault)
    check(float(rel_fault.max()) > MOE_EP_REL,
          f"16a: rank {MESH_LM_DROP_RANK}'s partial dropped reads "
          f"{float(rel_fault.max()):.4e} of max|logit| at most, within the "
          f"tolerance {MOE_EP_REL}")
    out["16a"] = {
        "arch": MESH_LM_ARCH, "layers": cfg.n_layers, "params": n_params,
        "mesh": list(MESH_LM_MESH), "devices": where, "steps": run["steps"],
        "tokens": run["tokens"], "rel_max": float(rel.max()),
        "rel_median": float(np.median(rel)), "tokens_held": held,
        "fault_rel_max": float(rel_fault.max()),
        "fault_rows_over": int((rel_fault > MOE_EP_REL).sum()),
        "fault_rows": int(rel_fault.size), "k5_launches": counts["replay"],
        "k5_plain_s": plain_s, "wall_s": run["wall_s"],
        "ep_step_ms": [e for e, _ in run["step_ms"]],
        "grouped_step_ms": [g for _, g in run["step_ms"]],
        "tolerance": f"{MOE_EP_REL} of each row's max|logit|; greedy tokens "
                     f"== where the grouped margin > {2 * MOE_EP_REL} of it"}
    print(f"[16a] {MESH_LM_ARCH} at full width ({cfg.n_layers} of "
          f"{get_config(MESH_LM_ARCH).n_layers} layers, {n_params:,} "
          f"parameters with the vocabulary padded to {cfg.vocab_padded}, "
          f"bf16), moe_impl=\"ep\" over a {MESH_LM_MESH} "
          f"(data, model) mesh of {where}, {cfg.n_experts // MESH_LM_MESH[1]}"
          f" experts a position: {len(prompts)} requests served in "
          f"{run['steps']} steps through PumServeOffload "
          f"({counts['replay']} K5 launches = chip rounds, each equal to the "
          f"plain replay); against the grouped decode of the same tokens "
          f"largest difference {float(rel.max()):.4e} of max|logit| (median "
          f"{float(np.median(rel)):.4e}; tolerance {MOE_EP_REL}), greedy "
          f"tokens equal at {held[0]} of {held[1]} rows; rank "
          f"{MESH_LM_DROP_RANK}'s partial dropped reads "
          f"{float(rel_fault.max()):.4e} ({out['16a']['fault_rows_over']} of "
          f"{rel_fault.size} rows over); served wall {run['wall_s']:.2f} s "
          f"with the lockstep twin, model step median "
          f"{float(np.median(out['16a']['ep_step_ms'])):.1f} ms ep, "
          f"{float(np.median(out['16a']['grouped_step_ms'])):.1f} ms grouped "
          f"(host clock, synchronized); {card}", flush=True)
    del params, run, fault
    release_device_memory("16b")

    # -- 16b: the elastic drill, (4, 2) -> (2, 2) ----------------------------
    phase("16b")
    t_b = time.perf_counter()
    scfg = smoke_config("yi-6b").replace(param_dtype="float32")
    p0 = init_lm(scfg, generator=torch.Generator(dev).manual_seed(18),
                 device=dev)
    dc = DataConfig(*DRILL_DATA)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in synth_batch(scfg, dc, s).items()}
               for s in range(8)]
    step = make_train_step(scfg, opt.AdamWConfig(**DRILL_OPT))

    def make(m):
        ps = shd.param_shardings(p0, m)
        os_ = shd.opt_shardings(opt.init(p0), p0, m)
        bs = shd.batch_shardings(batches[0], m)
        return ps, os_, shd.sharded_step(step, (ps, os_, bs), (ps, os_, None))

    def shards_equal(tree, m) -> int:
        n = 0
        for leaf in flatten(tree):
            check(isinstance(leaf, shd.Sharded) and leaf.sharding.mesh is m,
                  f"16b: a leaf is not sharded over {m}: {leaf!r}")
            whole = leaf.gather(dev)
            for k, (idx, part) in enumerate(zip(
                    leaf.sharding.indices(leaf.shape), leaf.shards)):
                check(part.device == torch.device(m.devices[k]) and
                      torch.equal(part, whole[idx]),
                      f"16b: shard {k} of {leaf!r} is not its slice of the "
                      f"gathered leaf on its position's device")
                n += 1
        return n

    ckpt_dir = tempfile.mkdtemp(prefix="elastic_", dir=str(ROOT / "build"))
    torch.use_deterministic_algorithms(True)
    try:
        params, state, straight = p0, opt.init(p0), []
        for b in batches:
            params, state, m = step(params, state, b)
            straight.append(float(m["loss"]))
        mesh8, where8 = _split_mesh(DRILL_MESHES[0], ("data", "model"))
        ps, os_, step8 = make(mesh8)
        params, state = shd.place(p0, ps), shd.place(opt.init(p0), os_)
        losses = []
        for b in batches[:4]:
            params, state, m = step8(params, state, b)
            losses.append(float(m["loss"]))
        n_shards = shards_equal(params, mesh8) + shards_equal(state, mesh8)
        ckpt.save(ckpt_dir + "/p", 4, params)
        ckpt.save(ckpt_dir + "/o", 4, state)
        plan = recovery_plan(n_alive_chips=4, model_parallel=2,
                             chips_per_pod=8)
        check(tuple(plan["mesh_shape"][1:]) == DRILL_MESHES[1],
              f"16b: recovery_plan(4, 2, 8) gives {plan['mesh_shape']}")
        mesh4, where4 = _split_mesh(DRILL_MESHES[1], ("data", "model"))
        ps4, os4, step4 = make(mesh4)
        params = ckpt.reshard_restore(ckpt_dir + "/p", 4, p0, ps4)
        state = ckpt.reshard_restore(ckpt_dir + "/o", 4, opt.init(p0), os4)
        n_shards += shards_equal(params, mesh4) + shards_equal(state, mesh4)
        for b in batches[4:]:
            params, state, m = step4(params, state, b)
            losses.append(float(m["loss"]))
        n_shards += shards_equal(params, mesh4)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(losses == straight, f"16b: the drill's losses {losses} != the "
          f"unsharded run's {straight}")
    check(all(np.isfinite(losses)), f"16b: losses {losses}")
    out["16b"] = {"losses": losses, "meshes": [list(m) for m in DRILL_MESHES],
                  "devices": [where8, where4], "plan": plan["mesh_shape"],
                  "shards_checked": n_shards,
                  "seconds": time.perf_counter() - t_b}
    print(f"[16b] the elastic drill (smoke yi-6b, float32, deterministic "
          f"algorithms): 4 sharded steps on {DRILL_MESHES[0]} ({where8}), "
          f"save, recovery_plan(4, 2, 8) -> {plan['mesh_shape']}, "
          f"reshard_restore onto {DRILL_MESHES[1]} ({where4}), 4 more: the 8 "
          f"losses == the unsharded run's ({', '.join(f'{v:.4f}' for v in losses)}); "
          f"{n_shards} shards == their slices of the gathered leaves, each "
          f"on its position's device; {card}", flush=True)
    del p0, params, state, batches

    # -- 16c: gpipe, one stage a position, each on its own stream -----------
    phase("16c")
    t_c = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "16c: TF32 matmuls are on")
    pcfg = get_config(DIST_ARCH).replace(n_layers=GPIPE_LAYERS,
                                          param_dtype="float32")
    gen = torch.Generator(dev).manual_seed(19)
    blocks = init_lm(pcfg, generator=gen, device=dev)["blocks"]
    x = torch.randn((PIPE_BATCH, PIPE_SEQ, pcfg.d_model), generator=gen,
                    device=dev)
    positions = torch.arange(PIPE_SEQ, dtype=torch.int32, device=dev)
    pmesh, pwhere = _split_mesh((DIST_STAGES,), ("pod",))
    seen = []

    def stage_fn(stage, h):
        seen.append((h.device, torch.cuda.current_stream(h.device)))
        p = positions.to(h.device)[None].expand(h.shape[0], PIPE_SEQ)
        for lp in unstack(stage):
            h = block_forward(lp, h, p, pcfg)[0]
        return h

    live = tree_map(lambda t: t.detach().requires_grad_(), blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_pipe = gpipe(stage_fn, split_stages(live, DIST_STAGES), x, mesh=pmesh,
                   n_micro=PIPE_MICRO)
    g_pipe = torch.autograd.grad((h_pipe ** 2).sum(), flatten(live))
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    h_pipe = h_pipe.detach()
    want_streams = [pmesh.stream_at(k, pmesh.device_at(k, dev))
                    for k in range(DIST_STAGES)]
    ticks = PIPE_MICRO + DIST_STAGES - 1
    check(len(seen) == ticks * DIST_STAGES and all(
        st == want_streams[i % DIST_STAGES] for i, (_, st) in enumerate(seen))
        and len(set(want_streams)) == DIST_STAGES
        and torch.cuda.default_stream(dev) not in want_streams,
        "16c: the stages did not each run on their own position's stream")
    seen.clear()
    t0 = time.perf_counter()
    h_seq = stage_fn(live, x)
    g_seq = torch.autograd.grad((h_seq ** 2).sum(), flatten(live))
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    err_h = _pipe_err(h_pipe, h_seq, "the pipeline's output", "16c")
    names = flatten(shd.tree_map_with_path(lambda k, _: ".".join(k), blocks))
    err_g = max(_pipe_err(a, w, f"grad of blocks.{name}", "16c")
                for a, w, name in zip(g_pipe, g_seq, names))
    out["16c"] = {"stages": DIST_STAGES, "devices": pwhere,
                  "layers": GPIPE_LAYERS, "n_micro": PIPE_MICRO,
                  "err_out": err_h, "err_grads": err_g, "tolerance": PIPE_TOL,
                  "pipe_s": pipe_s, "seq_s": seq_s}
    print(f"[16c] gpipe over {DIST_STAGES} positions of pod ({pwhere}), one "
          f"stage of {GPIPE_LAYERS // DIST_STAGES} {DIST_ARCH} blocks (full "
          f"width, float32) a position, each on its own stream "
          f"({ticks} ticks): output and grads of sum(h**2) within {PIPE_TOL} "
          f"(|want| + max|want|) of the sequential blocks (largest error / "
          f"max|want|: output {err_h:.3e}, grads {err_g:.3e}); "
          f"forward+backward {pipe_s:.2f} s piped, {seq_s:.2f} s "
          f"sequential; {card}", flush=True)
    del blocks, live, h_pipe, h_seq, g_pipe, g_seq, x
    kern["replay"]["mesh_lm"] = {"launches": counts["replay"],
                                 "round_plain_s": plain_s}
    t_end = time.perf_counter()
    out["seconds"] = t_end - t_phase
    out["part_seconds"] = {"16a": t_b - t_phase, "16b": t_c - t_b,
                           "16c": t_end - t_c}
    print(f"[16] mesh LM path: launches {counts}; phase 16 took "
          f"{out['seconds']:.1f} s ({json.dumps({k: round(v, 1) for k, v in out['part_seconds'].items()})}); {card}",
          flush=True)
    return counts


def _graphed_step(step, params, caches, dev):
    """``step`` (``make_serve_step``'s function) on one slot captured as a
    CUDA graph after one warm-up call on a side stream: (graph, token and
    position input tensors, logits output tensor).  A replay runs the
    step on whatever the inputs hold and writes the caches in place."""
    import torch
    tok = torch.zeros(1, dtype=torch.int64, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(params, caches, tok, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, _ = step(params, caches, tok, pos)
    return graph, tok, pos, logits


def _matmul_weights(params):
    """(key path, tensor) of every weight a matrix product reads: the
    dense, MoE and router weights and the readout (not the embedding
    table, which a lookup reads, nor the SSM's depthwise conv)."""
    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            elif v.dim() >= 2 and k not in ("emb", "conv_w"):
                yield ".".join(path + (k,)), v
    yield from walk(params, ())


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", help="also write the full record here")
    p.add_argument("--trace", default=str(ROOT / "build" /
                                          "serving_channel_trace.json"),
                   help="where phase 9c writes its Chrome trace")
    args = p.parse_args()
    # cuBLAS picks its algorithms reproducibly with a fixed workspace; it
    # reads this when its first handle is made, so before torch starts
    # CUDA (phase 10b holds two served runs bit for bit)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    needed = [EXPERIMENTS / "popmma_probe.py", ROOT / "BENCH_apps.json",
              ROOT / "BENCH_serving.json", ROOT / "scripts" / "check_trace.py",
              *(ROOT / "examples_torch" / f"{name}.py"
                for name in EXAMPLE_KERNELS)]
    if not (SRC / "repro_torch").is_dir() or not all(
            f.is_file() for f in needed):
        print(f"chip_smoke: no port package under {SRC}, or one of "
              f"{', '.join(str(f) for f in needed)} is missing",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(SRC), str(EXPERIMENTS)]
    card = nvidia_smi("name,power.limit")
    print(f"[0] {card}")
    print(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, SM clock now/max "
          f"{nvidia_smi('clocks.sm,clocks.max.sm')}")
    try:
        record = run(args.trace)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    stop_phase_clock()
    record["phase_wall_s"] = PHASE_WALL
    print("[times] wall s by phase " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_WALL.items()}))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": record["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
