"""The port's dry run on the CPU (``meta`` tensors, no storage).

- The reference's own dry-run cell, internvl2-1b x decode_32k on the
  2 x 16 x 16 mesh at full width: the per-device argument bytes ``==`` the
  sum over the reference's specs (params, caches, tokens, positions),
  computed here, 119,685,856; that is XLA's 119,682,720 in the tracked
  ``experiments/dryrun/`` artifact (read, never written) plus the
  3,136 B of ``frontend_proj.w``, which decode never reads and XLA
  prunes from the arguments.  ``params``, ``active_params``, ``tokens``,
  ``kind`` and ``n_devices`` ``==`` the reference's.
- The same cell's fields counted from position 0's partitioned program:
  ``collective_bytes`` by kind ``==`` a closed form worked out here from
  the reference's specs, ``bytes_per_device`` at least the argument
  bytes, argument and output bytes within ``peak_bytes``, ``temp_bytes``
  the peak less both.  ``DeviceBytes`` on a program of known sizes
  reads its exact bytes and peak; a cell whose SSD heads divide
  neither way over 16 model ranks fills the four fields, its
  collective bytes ``==`` the closed form.
- The smoke granite-moe-1b-a400m x decode_32k cell with
  ``moe_impl="dense"``: its collective bytes ``==`` the closed form.
- The smoke yi-6b x train_4k cell, counted from position 0's partitioned
  train step: its all-gather and reduce-scatter bytes ``==`` their
  closed form (the forward's and the recompute's gathers, the
  gradients' reduce-scatters).
- The smoke mamba2-370m x long_500k and hymba-1.5b x decode_32k cells:
  their collective bytes ``==`` the closed form of the partitioned
  decode's gathers and sums, their ``ssm`` and ``conv`` cache shards in
  the argument bytes.
- The smoke seamless-m4t-medium x decode_32k cell (its cross-attention
  over the memory) and yi-6b x decode_32k with an int8 KV cache: their
  collective bytes ``==`` the closed form, their memory and int8 cache
  shards in the argument bytes.
- A train, a prefill and a decode cell at ``smoke_config``: the counted
  FLOPs ``==`` a closed-form count of their matrix products.
- The command line prints ``ok=1`` with JAX blocked from importing.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.distributed import sharding as ref_shd
from repro.models import transformer as ref_tf
from repro_torch.configs import smoke_config
from repro_torch.launch.dryrun import DeviceBytes, lower_cell, save_result
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import SHAPES_BY_NAME

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "experiments" / "dryrun" / "internvl2-1b_decode_32k_2x16x16.json"
CELL_ARGUMENT_BYTES = 119_685_856


def ref_shard_bytes(mesh, sds, spec) -> int:
    n = math.prod(sds.shape) * jnp.dtype(sds.dtype).itemsize
    for ax in spec:
        if ax is not None:
            n //= math.prod(mesh.shape[a] for a in
                            ((ax,) if isinstance(ax, str) else ax))
    return n


def ref_tree_bytes(mesh, tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shards = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(shards)
    return sum(ref_shard_bytes(mesh, l, s.spec) for l, s in zip(leaves, shards))


@pytest.fixture(scope="module")
def cell():
    return lower_cell("internvl2-1b", "decode_32k", multi_pod=True)


def test_cell_argument_bytes_equal_reference_specs(cell):
    rcfg = ref_get_config("internvl2-1b")
    shape = SHAPES_BY_NAME["decode_32k"]
    mesh = ref_shd.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    params = jax.eval_shape(lambda k: ref_tf.init_lm(k, rcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    caches = jax.eval_shape(lambda: ref_tf.init_caches(
        rcfg, shape.global_batch, shape.seq_len))
    vec = jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32)
    want = (ref_tree_bytes(mesh, params, ref_shd.param_shardings(params, mesh))
            + ref_tree_bytes(mesh, caches,
                             ref_shd.cache_shardings(caches, mesh))
            + 2 * ref_shard_bytes(mesh, vec, ref_shd.vector_sharding(
                mesh, shape.global_batch).spec))
    assert want == CELL_ARGUMENT_BYTES
    assert cell["memory"]["argument_bytes"] == want

    # XLA's number, read from the tracked artifact, plus the pruned
    # frontend_proj.w shard
    xla = json.loads(ARTIFACT.read_text())
    fp = params["frontend_proj"]["w"]
    fp_spec = ref_shd.param_shardings(params, mesh)["frontend_proj"]["w"].spec
    pruned = ref_shard_bytes(mesh, fp, fp_spec)
    assert pruned == 3_136
    assert cell["memory"]["argument_bytes"] == \
        xla["memory"]["argument_bytes"] + pruned
    for key in ("params", "active_params", "tokens", "kind", "n_devices",
                "arch", "shape", "mesh", "variant"):
        assert cell[key] == xla[key], key
    assert cell["params"] == rcfg.param_count()
    assert set(xla) <= set(cell)


def test_cell_collectives_equal_closed_form(cell):
    """Position 0's collectives ``==`` the closed form from the
    reference's specs: the FSDP all-gather of each layer's weights over
    ``pod`` and ``data`` (each output the shard times 32) and of the
    readout; q, k, v and o gathered whole over ``model`` too, since 14
    query and 2 kv heads do not divide over 16 ranks (the cache splits
    ``head_dim``); all-reduces of the embedding's masked lookup (bf16),
    of each layer's two row-parallel outputs and of its partial scores
    (both float32), twice the input bytes (ring accounting)."""
    rcfg = ref_get_config("internvl2-1b")
    mesh = ref_shd.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    params = jax.eval_shape(lambda k: ref_tf.init_lm(k, rcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    specs = ref_shd.param_shardings(params, mesh)
    n_data, layers = 2 * 16, rcfg.n_layers

    def shard(*path):
        leaf, spec = params, specs
        for k in path:
            leaf, spec = leaf[k], spec[k]
        assert ("pod", "data") in tuple(spec.spec), path
        n = ref_shard_bytes(mesh, leaf, spec.spec)
        return n // layers if path[0] == "blocks" else n

    def whole(*path):
        leaf = params
        for k in path:
            leaf = leaf[k]
        return math.prod(leaf.shape[1:]) * 2

    attn = [("blocks", "attn", n, "w") for n in ("q", "k", "v", "o")]
    ffn = [("blocks", "mlp", n, "w") for n in ("up", "gate", "down")]
    per_layer = sum(n_data * shard(*p) + whole(*p) for p in attn) + sum(
        n_data * shard(*p) for p in ffn)
    gathers = layers * per_layer + n_data * shard("out", "w")
    b_loc, d, s = 128 // n_data, rcfg.d_model, 32768
    embed = b_loc * d * 2                        # bf16 (4, 896)
    row = b_loc * d * 4                          # float32 (4, 1, 896)
    scores = b_loc * rcfg.n_heads * s * 4        # float32 (4, 2, 7, 1, s)
    reduces = 2 * (embed + layers * (2 * row + scores))
    assert gathers == 149_811_200 and reduces == 353_712_128
    assert cell["collective_bytes"] == {
        "all-gather": gathers, "all-reduce": reduces, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0, "total": gathers + reduces}
    assert cell["collective_bytes_raw"] == cell["collective_bytes"]


def test_cell_bytes_and_memory_bound_each_other(cell):
    """The four fields are numbers: bytes accessed at least the argument
    bytes, argument and output bytes within the peak, temp the peak less
    both; the FLOPs stay the unpartitioned count over the devices, and
    nothing but the depth calibration is unmeasured."""
    assert cell["depth_calibrated"] is False
    assert cell["flops_per_device_raw"] == cell["flops_per_device"]
    mem = cell["memory"]
    assert cell["bytes_per_device"] >= mem["argument_bytes"]
    assert mem["argument_bytes"] + mem["output_bytes"] <= mem["peak_bytes"]
    assert mem["temp_bytes"] == (mem["peak_bytes"] - mem["argument_bytes"]
                                 - mem["output_bytes"]) > 0
    assert set(cell["not_measured"]) == {"depth_calibrated"}
    # bf16 logits (128 x vocab / 16 model ranks, 4 rows a device) + caches
    cfg = ref_get_config("internvl2-1b")
    caches = 24 * 2 * 4 * 32768 * 2 * 4 * 2
    assert mem["output_bytes"] == caches + 4 * (cfg.vocab_padded // 16) * 2


def test_device_bytes_of_a_known_program():
    """``DeviceBytes`` on a program of known sizes: a view counts once
    and moves nothing, an in-place output counts once, a storage lives
    until its last view goes."""
    a = torch.empty(256, dtype=torch.float32, device="meta")  # 1,024 B
    with DeviceBytes([a]) as c:
        b = a + a                   # reads 2,048, writes 1,024; live 2,048
        v = b.view(16, 16)          # a view: nothing
        del b                       # v keeps the storage
        d = v.sum(0)                # reads 1,024, writes 64; live 2,112
        del v                       # 1,024 freed; live 1,088
        e = torch.cat([d, d])       # reads 128, writes 128; live 1,216
        e.mul_(e)                   # in place: reads 256, nothing new
        assert c.live == 1_216
    assert c.accessed == 3_072 + 1_088 + 256 + 256
    assert c.peak == 2_112
    # temp: the peak less the argument and the output e
    assert c.peak - 1_024 - 128 == 960


@pytest.mark.parametrize("arch,shape_name,replace,why", [
    ("mamba2-370m", "decode_32k", {"ssm_expand": 3, "ssm_head_dim": 24},
     "8 SSD heads of 24 over 16 model ranks: neither divides")])
def test_cells_not_partitioned_say_why(arch, shape_name, replace, why):
    """A cell of a config the partitioned program once refused (smoke
    mamba2-370m with a ``d_inner`` of 192 in 8 SSD heads of 24, neither
    of which divides 16 model ranks) fills all four fields: every
    ``model`` rank computes the whole SSD of its rows, so each SSM
    layer's all-gather bytes ``==`` :func:`_ssm_gathers`' closed form
    (``in_proj_z`` and ``out_proj`` gathered whole over ``data``, then
    ``model``; ``in_proj_xbc`` and ``in_proj_dt`` over ``data``; the 208
    conv channels, which do divide, gathered over ``model``), and the
    only all-reduce is the embedding's lookup (bf16): the SSD's norm
    and output need none."""
    from repro_torch.distributed.partition_ssm import conv_split, ssm_mode
    cfg = smoke_config(arch).replace(**replace)
    res = lower_cell(arch, shape_name, cfg_override=cfg)
    n_data, tp, layers, d = 16, 16, cfg.n_layers, cfg.d_model
    assert why.startswith(f"{cfg.ssm_heads} SSD heads of "
                          f"{cfg.ssm_head_dim}")
    assert ssm_mode(cfg, tp) == "full" and conv_split(cfg, tp)
    rows = SHAPES_BY_NAME[shape_name].global_batch // n_data
    gathers = layers * _ssm_gathers(cfg, rows, tp)
    reduces = 2 * rows * d * 2
    assert (gathers, reduces) == (116_480, 2_048)
    assert res["collective_bytes"] == {
        "all-gather": gathers, "all-reduce": reduces, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0, "total": gathers + reduces}
    assert res["collective_bytes_raw"] == res["collective_bytes"]
    mem = res["memory"]
    assert res["bytes_per_device"] >= mem["argument_bytes"] > 0
    assert mem["argument_bytes"] + mem["output_bytes"] <= mem["peak_bytes"]
    assert mem["temp_bytes"] == (mem["peak_bytes"] - mem["argument_bytes"]
                                 - mem["output_bytes"]) > 0
    assert set(res["not_measured"]) == {"depth_calibrated"}


def test_smoke_dense_moe_cell_equals_closed_form():
    """granite-moe-1b-a400m x decode_32k with ``moe_impl="dense"`` at
    ``smoke_config`` on 16 x 16, counted from position 0's partitioned
    decode: all four fields are numbers, and the all-gather and
    all-reduce bytes ``==`` their closed form.  The 2 kv heads do not
    divide 16 model ranks, so the cache splits ``head_dim`` and q, k, v
    and o are gathered whole (over ``data``, each output the shard
    times 16, then over ``model``); the 4 experts do not divide 16
    ranks either, so every rank runs all of them on its own rows (the
    up, gate and down stacks gathered over ``data``) and their sum
    needs no all-reduce.  All-reduces, twice their input bytes: the
    embedding's lookup (bf16), each layer's partial scores over the
    32,768 slots and its attention output's row partial (float32).  The
    dense dispatch gathers no rows; serving drops the aux, as the
    reference's compiled step does."""
    arch, replace = "granite-moe-1b-a400m", {"moe_impl": "dense"}
    res = lower_cell(arch, "decode_32k",
                     cfg_override=smoke_config(arch).replace(**replace))
    rcfg = ref_smoke_config(arch).replace(**replace)
    mesh = ref_shd.abstract_mesh((16, 16), ("data", "model"))
    params = jax.eval_shape(lambda k: ref_tf.init_lm(k, rcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    specs = ref_shd.param_shardings(params, mesh)
    layers, n_data, d = rcfg.n_layers, 16, rcfg.d_model
    rows, slots = SHAPES_BY_NAME["decode_32k"].global_batch // n_data, 32768

    def gathered(*path, whole=False):
        t, spec = params["blocks"], specs["blocks"]
        for k in path:
            t, spec = t[k], spec[k]
        assert "data" in tuple(spec.spec), path
        n = ref_shard_bytes(mesh, t, spec.spec) // layers
        return n_data * n + (math.prod(t.shape[1:]) * 2 if whole else 0)

    per_layer = sum(gathered("attn", n, "w", whole=True)
                    for n in ("q", "k", "v", "o")) + sum(
        gathered("moe", n) for n in ("up", "gate", "down"))
    gathers = layers * per_layer
    scores = rows * rcfg.n_heads * slots * 4
    reduces = 2 * (rows * d * 2 + layers * (scores + rows * d * 4))
    assert (gathers, reduces) == (150_528, 16_787_456)
    assert res["collective_bytes"] == {
        "all-gather": gathers, "all-reduce": reduces, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0, "total": gathers + reduces}
    mem = res["memory"]
    assert None not in (res["bytes_per_device"], mem["temp_bytes"],
                        mem["peak_bytes"])
    assert mem["argument_bytes"] + mem["output_bytes"] <= mem["peak_bytes"]
    assert set(res["not_measured"]) == {"depth_calibrated"}


@pytest.mark.parametrize("arch,replace", [
    ("seamless-m4t-medium", {}), ("yi-6b", {"kv_cache_dtype": "int8"})])
def test_smoke_encdec_and_int8_kv_cells_equal_closed_form(arch, replace):
    """seamless-m4t-medium x decode_32k (a memory of 8,192 frames a row)
    and yi-6b x decode_32k with an int8 KV cache, at ``smoke_config`` on
    16 x 16, counted from position 0's partitioned decode: the
    all-gather and all-reduce bytes ``==`` their closed form.  The 2 kv
    heads do not divide 16 model ranks, so the cache splits
    ``head_dim`` and q, k, v and o are gathered whole (over ``data``,
    each output the shard times 16, then over ``model``); seamless's
    cross-attention (neither its 4 query nor its 2 kv heads divide 16)
    runs whole, its four weights gathered likewise, with no all-reduce
    of its own; the MLP's weights are gathered over ``data``, and yi's
    untied readout too.  All-reduces, twice their input bytes: the
    embedding's lookup (bf16), each layer's partial scores over the
    32,768 slots and its two row-parallel outputs (float32), and, for the
    int8 cache, each layer's max all-reduce of the fresh k and v rows'
    amax (float32).  The argument bytes hold the reference's specs of
    the params, the caches (int8 entries and float32 scales), the two
    vectors and the memory."""
    cfg = smoke_config(arch).replace(**replace)
    res = lower_cell(arch, "decode_32k", cfg_override=cfg)
    rcfg = ref_smoke_config(arch).replace(**replace)
    mesh = ref_shd.abstract_mesh((16, 16), ("data", "model"))
    params = jax.eval_shape(lambda k: ref_tf.init_lm(k, rcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    specs = ref_shd.param_shardings(params, mesh)
    shape = SHAPES_BY_NAME["decode_32k"]
    layers, n_data, d = rcfg.n_layers, 16, rcfg.d_model
    rows, slots = shape.global_batch // n_data, shape.seq_len
    int8 = rcfg.kv_cache_dtype == "int8"

    def gathered(*path, whole=False):
        t, spec = params, specs
        for k in path:
            t, spec = t[k], spec[k]
        assert "data" in tuple(spec.spec), path
        n = ref_shard_bytes(mesh, t, spec.spec)
        n = n // layers if path[0] == "blocks" else n
        return n_data * n + (math.prod(t.shape[1:]) * 2 if whole else 0)

    mixers = ("attn", "xattn") if rcfg.is_encdec else ("attn",)
    mlp = [n for n in ("up", "gate", "down") if n in params["blocks"]["mlp"]]
    per_layer = sum(gathered("blocks", a, n, "w", whole=True)
                    for a in mixers for n in ("q", "k", "v", "o")) + sum(
        gathered("blocks", "mlp", n, "w") for n in mlp)
    readout = 0 if rcfg.tie_embeddings else gathered("out", "w")
    gathers = layers * per_layer + readout
    scores = rows * rcfg.n_heads * slots * 4
    amax = 2 * rows * rcfg.n_kv_heads * 4 if int8 else 0
    reduces = 2 * (rows * d * 2 + layers * (scores + 2 * rows * d * 4 + amax))
    assert (gathers, reduces) == {
        "seamless-m4t-medium": (108_544, 16_795_648),
        "yi-6b": (60_416, 16_796_160)}[arch]
    assert res["collective_bytes"] == {
        "all-gather": gathers, "all-reduce": reduces, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0, "total": gathers + reduces}

    caches = jax.eval_shape(lambda: ref_tf.init_caches(
        rcfg, shape.global_batch, slots))
    cs = ref_shd.cache_shardings(caches, mesh)
    assert set(caches["attn"]) == ({"k", "v", "k_scale", "v_scale"} if int8
                                   else {"k", "v"})
    vec = jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32)
    want = (ref_tree_bytes(mesh, params, specs)
            + ref_tree_bytes(mesh, caches, cs)
            + 2 * ref_shard_bytes(mesh, vec, ref_shd.vector_sharding(
                mesh, shape.global_batch).spec))
    if rcfg.is_encdec:
        mem = jax.ShapeDtypeStruct((shape.global_batch, slots // 4, d),
                                   jnp.bfloat16)
        want += ref_shard_bytes(mesh, mem, ref_shd.batch_shardings(
            {"m": mem}, mesh)["m"].spec)
    mem_ = res["memory"]
    assert mem_["argument_bytes"] == want
    assert mem_["argument_bytes"] + mem_["output_bytes"] <= mem_["peak_bytes"]
    assert res["bytes_per_device"] >= mem_["argument_bytes"]
    assert set(res["not_measured"]) == {"depth_calibrated"}


def test_smoke_train_cell_gathers_equal_closed_form():
    """yi-6b x train_4k at ``smoke_config`` on 16 x 16, counted from
    position 0's partitioned train step (``remat="dots"``): the
    all-gather and reduce-scatter bytes ``==`` the closed form from the
    reference's specs.  The block weights are gathered over ``data`` in
    the forward and again in the recompute (each output the shard times
    16); q, k, v and o are gathered whole over ``model`` too, since 4
    query and 2 kv heads do not divide over 16 ranks (attention splits
    ``head_dim``); the readout is gathered once, and the loss gathers
    each rank's float32 log-sum-exp of its 16 x 4,096 positions.  Each
    weight gather's backward reduce-scatters its gradient once (its
    input the gather's output); the other fields are numbers."""
    from repro_torch.distributed.partition import _attention_mode
    cfg = smoke_config("yi-6b")
    res = lower_cell("yi-6b", "train_4k", cfg_override=cfg)
    rcfg = ref_smoke_config("yi-6b")
    mesh = ref_shd.abstract_mesh((16, 16), ("data", "model"))
    params = jax.eval_shape(lambda k: ref_tf.init_lm(k, rcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    specs = ref_shd.param_shardings(params, mesh)
    layers, n_data, tp = rcfg.n_layers, 16, 16
    assert _attention_mode(cfg, tp) == "hd" and cfg.n_heads % tp

    def leaf(*path):
        t, spec = params, specs
        for k in path:
            t, spec = t[k], spec[k]
        assert "data" in tuple(spec.spec), path
        n = ref_shard_bytes(mesh, t, spec.spec)
        return (n // layers if path[0] == "blocks" else n), \
            math.prod(t.shape[1:]) * 2

    per_layer = 0
    for name in ("q", "k", "v", "o"):
        shard, whole = leaf("blocks", "attn", name, "w")
        per_layer += n_data * shard + whole
    for name in ("up", "gate", "down"):
        per_layer += n_data * leaf("blocks", "mlp", name, "w")[0]
    readout = n_data * leaf("out", "w")[0]
    shape = SHAPES_BY_NAME["train_4k"]
    lse = tp * (shape.global_batch // n_data) * shape.seq_len * 4
    colls = res["collective_bytes"]
    assert colls["all-gather"] == 2 * layers * per_layer + readout + lse
    assert colls["reduce-scatter"] == layers * per_layer + readout
    assert per_layer == 29_184 and readout == 2_048 and lse == 4_194_304
    mem = res["memory"]
    assert res["bytes_per_device"] >= mem["argument_bytes"]
    assert mem["argument_bytes"] + mem["output_bytes"] <= mem["peak_bytes"]
    assert set(res["not_measured"]) == {"depth_calibrated"}


def _ssm_gathers(cfg, rows: int, tp: int) -> int:
    """All-gather bytes of one SSM mixer in a decode step whose SSD
    splits its head dim ``P`` (the smoke configs' 8 heads over 16 model
    ranks) or is whole at every ``model`` rank, and whose conv channels
    split: ``in_proj_z`` and ``out_proj`` gathered whole (over
    ``data``, then ``model``), ``in_proj_xbc`` and ``in_proj_dt`` over
    ``data``, and the convolved channels of ``rows`` rows over
    ``model``; bf16."""
    d, di = cfg.d_model, cfg.d_inner
    conv = di + 2 * cfg.ssm_state
    z = out = d * di // tp * 2 + d * di * 2
    return (z + out + d * conv // tp * 2 + d * cfg.ssm_heads * 2
            + rows * conv * 2)


@pytest.mark.parametrize("arch,shape_name", [
    ("mamba2-370m", "long_500k"), ("hymba-1.5b", "decode_32k")])
def test_smoke_ssm_cells_equal_closed_form(arch, shape_name):
    """mamba2-370m x long_500k (batch 1, replicated over ``data``) and
    hymba-1.5b x decode_32k (8 rows a position) at ``smoke_config`` on
    16 x 16, counted from position 0's partitioned decode: the
    all-gather and all-reduce bytes ``==`` their closed form.  The
    SSD's 8 heads do not divide 16 model ranks, so it splits ``P``
    (:func:`_ssm_gathers`); an all-reduce sums each SSM's norm (a float32
    mean square a row) and its row-parallel output (float32), and the
    embedding's lookup (bf16).  hymba adds attention split by
    ``head_dim`` (q, k, v and o gathered whole; its partial scores over
    the 16-slot ring and its output all-reduced), the MLP (hidden split;
    its output all-reduced) and the untied readout's gather (each weight
    gathered over ``data``: its output the shard times 16).  The
    ``ssm`` and ``conv`` caches' shards are in ``argument_bytes``, as
    the reference's specs lay them out."""
    cfg = smoke_config(arch)
    res = lower_cell(arch, shape_name, cfg_override=cfg)
    shape = SHAPES_BY_NAME[shape_name]
    n_data, tp, layers, d = 16, 16, cfg.n_layers, cfg.d_model
    rows = max(1, shape.global_batch // n_data)
    assert rows == (1 if arch.startswith("mamba2") else 8)
    gathers = layers * _ssm_gathers(cfg, rows, tp)
    reduces = 2 * (rows * d * 2 + layers * (rows * 4 + rows * d * 4))
    if cfg.sliding_window:
        hd, nh, g = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        qo = d * nh * hd // n_data * 2 + d * nh * hd * 2
        kv = d * g * hd // n_data * 2 + d * g * hd * 2
        ffn = 3 * d * cfg.d_ff // tp * 2
        gathers += layers * (2 * qo + 2 * kv + ffn) \
            + d * cfg.vocab_padded // tp * 2
        scores = rows * nh * cfg.sliding_window * 4
        reduces += 2 * layers * (scores + 2 * rows * d * 4)
    assert (gathers, reduces) == ({"mamba2-370m": (74_560, 1_296),
                                   "hymba-1.5b": (139_008, 34_944)}[arch])
    assert res["collective_bytes"] == {
        "all-gather": gathers, "all-reduce": reduces, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0, "total": gathers + reduces}

    rcfg = ref_smoke_config(arch)
    mesh = ref_shd.abstract_mesh((16, 16), ("data", "model"))
    params = jax.eval_shape(lambda k: ref_tf.init_lm(k, rcfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    caches = jax.eval_shape(lambda: ref_tf.init_caches(
        rcfg, shape.global_batch, shape.seq_len))
    cs = ref_shd.cache_shardings(caches, mesh)
    vec = jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32)
    ssm = {k: ref_shard_bytes(mesh, caches["ssm"][k], cs["ssm"][k].spec)
           for k in ("ssm", "conv")}
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    assert ssm == {
        "ssm": layers * rows * cfg.ssm_heads * cfg.ssm_state
        * (cfg.ssm_head_dim // tp) * 4,
        "conv": layers * rows * (cfg.ssm_conv - 1) * (conv_dim // tp) * 2}
    assert res["memory"]["argument_bytes"] == (
        ref_tree_bytes(mesh, params, ref_shd.param_shardings(params, mesh))
        + ref_tree_bytes(mesh, caches, cs)
        + 2 * ref_shard_bytes(mesh, vec, ref_shd.vector_sharding(
            mesh, shape.global_batch).spec))
    mem = res["memory"]
    assert mem["argument_bytes"] + mem["output_bytes"] <= mem["peak_bytes"]
    assert res["bytes_per_device"] >= mem["argument_bytes"]
    assert set(res["not_measured"]) == {"depth_calibrated"}


def test_cell_on_the_host_mesh_fits_one_card():
    res = lower_cell("internvl2-1b", "decode_32k",
                     mesh=make_host_mesh(device="cpu"))
    assert res["mesh"] == "1x1" and res["n_devices"] == 1
    caches = 24 * 2 * 128 * 32768 * 2 * 64 * 2
    assert caches == 51_539_607_552
    params = 630_713_216 * 2
    assert res["memory"]["argument_bytes"] == caches + params + 2 * 128 * 4
    assert res["memory"]["argument_bytes"] < 80e9


def closed_form_flops(cfg, shape) -> int:
    """Matrix products of a dense model: F, the unbatched weight
    products (2 x tokens x weights read), and A, attention's two einsums
    over every (query, key) pair.  A train step is the forward, the
    backward's two products for each, and the recompute of the
    attention einsums under ``remat="dots"``: 3F + 4A."""
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    weights = cfg.n_layers * (d * h * hd + 2 * d * g * hd + h * hd * d
                              + 3 * d * cfg.d_ff) + d * cfg.vocab_padded
    b, l = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        f = 2 * b * weights
        a = 4 * b * h * l * hd * cfg.n_layers
        return f + a
    f = 2 * b * l * weights
    a = 4 * b * h * l * l * hd * cfg.n_layers
    return 3 * f + 4 * a if shape.kind == "train" else f + a


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
@pytest.mark.parametrize("arch", ["yi-6b", "granite-3-8b"])
def test_smoke_flops_equal_closed_form(arch, shape_name):
    cfg = smoke_config(arch)
    assert not cfg.tie_embeddings and cfg.act == "swiglu"
    shape = SHAPES_BY_NAME[shape_name]
    res = lower_cell(arch, shape_name, cfg_override=cfg)
    assert res["n_devices"] == 256
    assert res["flops_per_device"] * 256 == closed_form_flops(cfg, shape)


def test_save_result_writes_where_asked(tmp_path):
    res = lower_cell("yi-6b", "decode_32k", cfg_override=smoke_config("yi-6b"),
                     variant="smoke")
    path = save_result(res, str(tmp_path))
    assert Path(path).name == "yi-6b_decode_32k_16x16_smoke.json"
    assert json.loads(Path(path).read_text())["flops_per_device"] == \
        res["flops_per_device"]


def test_cli_without_jax(tmp_path):
    before = ARTIFACT.read_bytes()
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['dryrun', '--arch', 'internvl2-1b', '--shape', "
            f"'decode_32k', '--mesh', 'multi', '--out', {str(tmp_path)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "print('jax' in sys.modules and sys.modules['jax'] is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "dryrun: ok=1 skip=0 fail=0" in out.stdout
    assert out.stdout.strip().endswith("False")
    res = json.loads((tmp_path / "internvl2-1b_decode_32k_2x16x16.json")
                     .read_text())
    assert res["memory"]["argument_bytes"] == CELL_ARGUMENT_BYTES
    assert ARTIFACT.read_bytes() == before


def test_meta_only_where_allowed(monkeypatch):
    """``meta`` passes for the model's and caches' init only; ``cuda``
    with no card still raises."""
    import numpy as np
    import torch

    from repro_torch.core import bitplane
    from repro_torch.kernels.build import resolve_device
    from repro_torch.models.transformer import init_caches, init_lm

    cfg = smoke_config("yi-6b")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        bitplane.bbop("addition", 8, np.arange(4), np.arange(4),
                      device="meta")
    with pytest.raises(ValueError, match="draws nothing"):
        init_lm(cfg, generator=torch.Generator(), device="meta")
    p = init_lm(cfg, device="meta")
    assert p["embed"]["emb"].device.type == "meta"
    assert init_caches(cfg, 2, 8, device="meta")["attn"]["k"].shape == \
        (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
