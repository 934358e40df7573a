"""The port's sharding tables against the JAX package's, at production shapes.

The reference's ``param_specs``, ``train_state_specs``, ``batch_spec`` and
``cache_specs`` run in this process on ``jax.sharding.AbstractMesh``; the
port's on a :class:`~repro_torch.distributed.sharding.MeshShape` of the same
names and sizes, over an ``LM`` and a decode cache built under
``FakeTensorMode`` (no memory).  The reference stacks its ``cycles``,
``encoder`` and ``cross`` leaves (and its cache's) under a leading scan axis
that is never sharded: its spec with that entry dropped must equal the
port's.  A one-name tuple entry and a name are the same entry (JAX's
``PartitionSpec`` keeps the name).
"""
import datetime
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as JS
from repro.models import abstract_params
from repro.models.decode import init_cache as jinit_cache
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.distributed import sharding as S
from repro_torch.models import decode as D
from repro_torch.models.lm import LM

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8": ((8,), ("data",)),
          "1x1": ((1, 1), ("data", "model"))}
LAYOUTS = ("tp_sp", "fsdp")
CACHE_SHAPES = ("decode_32k", "long_500k")


def _meshes(name):
    sizes, names = MESHES[name]
    return jax.sharding.AbstractMesh(sizes, names), S.MeshShape(names, sizes)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return abstract_params(jget_config(arch))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    with FakeTensorMode():
        model = LM(get_config(arch), "cpu", torch.bfloat16)
        return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries, one-name tuples as the name."""
    spec = S.normalize(tuple(spec))
    return spec + (None,) * (ndim - len(spec))


def _ref_leaf(tree, name, cfg):
    """The reference leaf (a NamedSharding or a shape struct) of port
    parameter ``name`` and whether it carries the stack axis."""
    parts = name.split(".")
    period = len(cfg.layer_pattern)
    cycled = cfg.num_layers // period * period
    stacked = False
    if parts[0] == "layers":
        i = int(parts[1])
        if i < cycled:
            node, stacked = tree["cycles"][i % period], True
        else:
            node = tree["rest"][i - cycled]
        parts = parts[2:]
    elif parts[0] in ("encoder", "cross"):
        node, stacked, parts = tree[parts[0]], True, parts[2:]
    else:
        node = tree
    for p in parts:
        node = node[p]
    return node, stacked


def _ref_specs(tree, names, cfg, ndims):
    out = {}
    for n in names:
        leaf, stacked = _ref_leaf(tree, n, cfg)
        spec = _norm(leaf.spec, ndims[n] + stacked)
        if stacked:
            assert spec[0] is None, (n, spec)
            spec = spec[1:]
        out[n] = spec
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_train_state_specs_equal_reference(arch, mesh, layout):
    cfg = jget_config(arch)
    jmesh, pmesh = _meshes(mesh)
    shapes = _port_shapes(arch)
    if layout == "tp_sp" and "model" not in MESHES[mesh][1]:
        # the tp_sp table names the model axis: both packages refuse a mesh without it
        with pytest.raises(KeyError):
            JS.param_specs(_ref_params(arch), jmesh)
        with pytest.raises(KeyError):
            S.param_specs(shapes, pmesh)
        return
    ndims = {n: len(s) for n, s in shapes.items()}
    ref = _ref_specs(JS.param_specs(_ref_params(arch), jmesh, layout), shapes, cfg, ndims)
    mine = {n: _norm(s, ndims[n]) for n, s in S.param_specs(shapes, pmesh, layout).items()}
    assert mine == ref
    jps, jopt = JS.train_state_specs(_ref_params(arch), jmesh, layout)
    ps, opt = S.train_state_specs(shapes, pmesh, layout)
    assert {n: _norm(s, ndims[n]) for n, s in ps.items()} == ref
    for moment in ("m", "v"):
        jm = _ref_specs(getattr(jopt, moment), shapes, cfg, ndims)
        assert {n: _norm(s, ndims[n]) for n, s in getattr(opt, moment).items()} == jm
    assert tuple(jopt.step.spec) == tuple(opt.step) == ()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_equals_reference(mesh, layout):
    jmesh, pmesh = _meshes(mesh)
    assert _norm(S.batch_spec(pmesh, layout), 2) == _norm(JS.batch_spec(jmesh, layout).spec, 2)


@pytest.mark.parametrize("shape", CACHE_SHAPES)
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "4x2", "1x1"])
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_reference_with_the_stack_axis_dropped(arch, mesh, shape):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmesh, pmesh = _meshes(mesh)
    sh = SHAPES[shape]
    jcache = jax.eval_shape(lambda: jinit_cache(jcfg, batch=sh.global_batch,
                                                max_seq=sh.seq_len, dtype=jnp.bfloat16))
    jspecs = JS.cache_specs(jcache, jcfg, JSHAPES[shape], jmesh)
    with FakeTensorMode():
        cache = D.init_cache(cfg, sh.global_batch, sh.seq_len, torch.bfloat16, "cpu")
        mine = S.cache_specs(cache, cfg, sh, pmesh)
    period = len(cfg.layer_pattern)
    cycled = cfg.num_layers // period * period
    assert len(mine) == cfg.num_layers
    for i, layer in enumerate(mine):
        node = jspecs["cycles"][i % period] if i < cycled else jspecs["rest"][i - cycled]
        for key, spec in layer.items():
            ref = (jspecs["cross"][key[-1]] if key.startswith("cross_") else node[key]).spec
            nd = cache[i][key].ndim
            ref = _norm(ref, nd + 1)
            assert ref[0] is None
            assert _norm(spec, nd) == ref[1:], (i, key)


def test_named_param_candidates_follow_the_reference_paths():
    """Spot checks of the rule table at production shapes: yi-9b's 4 KV
    heads do not divide 16, so ``wv`` shards ``hd``; grok's 8 experts fall
    back to TP on the expert FFN dim; the fsdp layout shards the first
    divisible dim over every axis."""
    mesh = S.MeshShape(("data", "model"), (16, 16))
    yi = S.param_specs(_port_shapes("yi-9b"), mesh)
    assert yi["layers.0.attn.wv"] == ("data", None, "model")
    assert yi["layers.0.attn.wq"] == ("data", "model", None)
    assert yi["embed"] == ("model", "data")
    grok = S.param_specs(_port_shapes("grok-1-314b"), mesh)
    assert grok["layers.0.moe.w_gate"] == (None, "data", "model")
    fsdp = S.param_specs(_port_shapes("mamba2-130m"), mesh, "fsdp")
    assert fsdp["layers.0.mamba.w_z"] == (("data", "model"), None)


def test_placements_round_trip_in_a_world_of_one(tmp_path):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1, 1),
                          mesh_dim_names=("pod", "data", "model"))
        cases = {(("pod", "data"), None, "model"): [Shard(0), Shard(0), Shard(2)],
                 (None, "model"): [Replicate(), Replicate(), Shard(1)],
                 ("data", None): [Replicate(), Shard(0), Replicate()],
                 (None, None): [Replicate()] * 3}
        for spec, want in cases.items():
            got = S.to_placements(spec, mesh)
            assert got == want
            assert S.spec_of(got, mesh, len(spec)) == spec
            assert S.to_placements(S.spec_of(want, mesh, len(spec)), mesh) == want
            t = torch.arange(24.0).reshape((2, 3, 4)[:len(spec)] if len(spec) == 3 else (4, 6))
            dt = S.distribute(t, mesh, spec)
            assert list(dt.placements) == want
            assert torch.equal(dt.full_tensor(), t)
        with pytest.raises(ValueError, match="axis order"):
            S.to_placements((("data", "pod"),), mesh)
    finally:
        dist.destroy_process_group()
