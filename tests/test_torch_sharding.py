"""The port's sharding rules against the reference's, on the CPU.

Every spec the port's rules give equals the reference's: each param
leaf of all 10 archs on both production meshes under the policies
``2d``, ``dp``, ``dp2`` and ``serve``, the ``dp2`` optimizer state, the
batch of every shape, the caches of every supported decode cell, and
the logits and vector layouts.  The reference's trees come from
``jax.eval_shape`` over abstract meshes (nothing is compiled); the
port's are built on the ``meta`` device.  The rest mirrors
``tests/test_sharding.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro_torch.configs import ARCHS, cell_is_supported, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.dryrun import input_specs
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.models.transformer import init_caches, init_lm
from repro_torch.train import optimizer as opt

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
POLICIES = ("2d", "dp", "dp2", "serve")
DTYPES = {torch.int32: jnp.int32, torch.float32: jnp.float32,
          torch.bfloat16: jnp.bfloat16}


def ref_mesh(name):
    return ref_shd.abstract_mesh(*MESHES[name])


def port_mesh(name):
    return shd.abstract_mesh(*MESHES[name])


def ref_specs(tree):
    """{key path: spec tuple} of a reference tree of NamedShardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): tuple(s.spec) for path, s in leaves}


def port_specs(tree):
    out = {}
    shd.tree_map_with_path(
        lambda path, s: out.__setitem__(tuple(map(str, path)),
                                        tuple(s.spec)), tree)
    return out


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    cfg = ref_get_config(arch)
    return jax.eval_shape(lambda k: ref_tf.init_lm(k, cfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return init_lm(get_config(arch), device="meta")


def to_sds(tree):
    """Meta tensors as the reference's ShapeDtypeStructs."""
    return {k: jax.ShapeDtypeStruct(tuple(t.shape), DTYPES[t.dtype])
            for k, t in tree.items()}


def test_archs_match():
    assert sorted(ARCHS) == sorted(REF_ARCHS)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_reference(arch, mesh_name, policy):
    want = ref_specs(ref_shd.param_shardings(ref_params(arch),
                                             ref_mesh(mesh_name), policy))
    got = port_specs(shd.param_shardings(port_params(arch),
                                         port_mesh(mesh_name), policy))
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m",
                                  "seamless-m4t-medium"])
def test_opt_specs_dp2_equal_reference(arch, mesh_name):
    rp = ref_params(arch)
    want = ref_specs(ref_shd.opt_shardings(
        jax.eval_shape(ref_opt.init, rp), rp, ref_mesh(mesh_name), "dp2"))
    pp = port_params(arch)
    got = port_specs(shd.opt_shardings(opt.init(pp), pp,
                                       port_mesh(mesh_name), "dp2"))
    assert got == want
    # the moments are the dp layout, the params' is dp2's
    assert got[("mu", "embed", "emb")] == tuple(port_specs(
        shd.param_shardings(pp, port_mesh(mesh_name), "dp"))[("embed",
                                                              "emb")])


@pytest.mark.parametrize("policy", ["2d", "dp"])
@pytest.mark.parametrize("shape_name", list(SHAPES_BY_NAME))
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b",
                                  "yi-6b"])
def test_batch_specs_equal_reference(arch, shape_name, policy):
    ins = input_specs(get_config(arch), SHAPES_BY_NAME[shape_name])
    for mesh_name in MESHES:
        want = ref_specs(ref_shd.batch_shardings(to_sds(ins),
                                                 ref_mesh(mesh_name), policy))
        got = port_specs(shd.batch_shardings(ins, port_mesh(mesh_name),
                                             policy))
        assert got == want


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_reference(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    if not cell_is_supported(cfg, shape):
        assert shape_name == "long_500k" and not cfg.subquadratic
        return
    rcfg = ref_get_config(arch)
    rc = jax.eval_shape(lambda: ref_tf.init_caches(
        rcfg, shape.global_batch, shape.seq_len))
    pc = init_caches(cfg, shape.global_batch, shape.seq_len, device="meta")
    for mesh_name in MESHES:
        want = ref_specs(ref_shd.cache_shardings(rc, ref_mesh(mesh_name)))
        got = port_specs(shd.cache_shardings(pc, port_mesh(mesh_name)))
        assert got == want


@pytest.mark.parametrize("batch", [1, 16, 32, 128, 256])
def test_logits_and_vector_specs_equal_reference(batch):
    for mesh_name in MESHES:
        rm, pm = ref_mesh(mesh_name), port_mesh(mesh_name)
        assert tuple(shd.logits_sharding(pm, batch).spec) == tuple(
            ref_shd.logits_sharding(rm, batch).spec)
        assert tuple(shd.vector_sharding(pm, batch).spec) == tuple(
            ref_shd.vector_sharding(rm, batch).spec)
        assert tuple(shd.replicated(pm).spec) == tuple(
            ref_shd.replicated(rm).spec) == ()


# -- tests/test_sharding.py, on the port ----------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_divide(arch, mesh_name):
    mesh = port_mesh(mesh_name)
    shards = shd.param_shardings(port_params(arch), mesh)

    def check(path, s):
        leaf = port_params(arch)
        for k in path:
            leaf = leaf[k]
        assert len(s.spec) <= leaf.dim()
        shape = s.shard_shape(leaf.shape)     # raises where one does not
        assert math.prod(shape) * mesh.size >= leaf.numel()

    shd.tree_map_with_path(check, shards)


def test_fit_spec_fallbacks():
    mesh = port_mesh("2x16x16")
    # batch of 1 -> fully replicated
    assert shd.fit_spec(mesh, (1,), ("pod", "data"))[0] is None
    # batch of 16 -> only the 'data' axis fits
    assert shd.fit_spec(mesh, (16,), ("pod", "data"))[0] == "data"
    # batch of 32 -> both axes
    assert shd.fit_spec(mesh, (32,), ("pod", "data"))[0] == ("pod", "data")
    # dim 50 on model(16) -> replicated
    assert shd.fit_spec(mesh, (50,), "model")[0] is None


def test_vocab_padding():
    for arch in ARCHS:
        cfg = get_config(arch)
        assert cfg.vocab_padded % 256 == 0
        assert 0 <= cfg.vocab_padded - cfg.vocab_size < 256


def test_fit_spec_never_violates_divisibility():
    from _hypothesis_compat import given, settings, st

    mesh = port_mesh("2x16x16")
    rmesh = ref_mesh("2x16x16")

    @given(st.integers(1, 4096), st.sampled_from(
        [None, "model", ("pod", "data"), ("pod", "data", "model")]))
    @settings(max_examples=100, deadline=None)
    def inner(dim, want):
        got = shd._fit(mesh, dim, want)
        assert dim % shd._axis_size(mesh, got) == 0
        assert got == ref_shd._fit(rmesh, dim, want)

    inner()


def test_sharding_shard_shape_and_bytes():
    mesh = port_mesh("2x16x16")
    s = shd.Sharding(mesh, shd.P(None, ("pod", "data"), None, None, "model"))
    t = torch.empty((24, 128, 32768, 2, 64), dtype=torch.bfloat16,
                    device="meta")
    assert s.shard_shape(t.shape) == (24, 4, 32768, 2, 4)
    assert s.shard_bytes(t) == 24 * 4 * 32768 * 2 * 4 * 2
    with pytest.raises(ValueError, match="does not divide"):
        shd.Sharding(mesh, shd.P("model")).shard_shape((50,))


def test_place_on_host_mesh_and_refusals():
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    params = init_lm(ARCHS["yi-6b"].replace(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab_size=256, head_dim=16), generator=torch.Generator().manual_seed(0),
        device="cpu")
    placed = shd.place(params, shd.param_shardings(params, mesh, "serve"))
    assert torch.equal(placed["embed"]["emb"], params["embed"]["emb"])
    with pytest.raises(ValueError, match="mesh of one device"):
        shd.place(params, shd.param_shardings(params, port_mesh("16x16")))
    two = Mesh((2, 1), ("data", "model"),
               [torch.device("cpu"), torch.device("cpu")])
    with pytest.raises(ValueError, match="mesh of one device"):
        shd.place(params, shd.param_shardings(params, two))
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model_parallel=2, device="cpu")
