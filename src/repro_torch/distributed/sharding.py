"""Sharding rules: parameter / optimiser / batch / cache specs, and their
DTensor placements.

Counterpart of ``repro/distributed/sharding.py``.  Layout: FSDP over the
data axes (and ``pod``), 1-D Megatron TP over ``model``, EP for MoE experts
over ``model``, SP for long sequences.

A *spec* has PartitionSpec form: a tuple with one entry a tensor dim, each
``None`` (replicated), an axis name, or a tuple of axis names (several mesh
dims on one tensor dim, major to minor).  The tables are keyed on the
port's parameter names (``named_parameters()``: ``layers.3.attn.wq``,
``shared_attn.mlp.w_up``, ``cross.0.attn.wk``, ...).  The reference stacks
its ``cycles``, ``encoder`` and ``cross`` leaves under a leading scan axis
that is never sharded; the port holds one module a layer, so a port spec is
the reference's with that leading ``None`` dropped.  The divisibility
rules, the fallback order and the FSDP layout's "first divisible dim" are
the reference's.

Parameter rule table (name pattern -> preferred spec):

  embed [V, D]            -> (tp, dp)       vocab-TP + FSDP on D
  lm_head [D, V]          -> (dp, tp)
  attn wq/wk/wv [D, H, hd] -> (dp, tp, None) heads-TP, FSDP on D
  attn wo [H, hd, D]      -> (tp, None, dp)
  mlp w_gate/w_up [D, F]  -> (dp, tp)
  mlp w_down [F, D]       -> (tp, dp)
  moe router [D, E]       -> (dp, None)
  moe w_* [E, D, F]       -> (tp, dp, None)  expert-parallel (EP)
  mamba w_z/w_x [D, di]   -> (dp, tp)
  mamba w_out [di, D]     -> (tp, dp)
  mamba small tensors     -> replicated
  norms / biases          -> replicated

Optimiser moments take the parameter specs (ZeRO: state sharded with the
parameters).  The tables compute from axis names and sizes alone: ``mesh``
is a ``DeviceMesh`` or a :class:`MeshShape` (the counterpart of JAX's
``AbstractMesh``), so production shapes need no world.  One mechanism
places tensors for both layouts: :func:`to_placements` turns a spec into
DTensor placements and :func:`distribute_params` makes every parameter a
DTensor with its table's placements (``fully_shard`` is not used: it would
place the FSDP layout a second way).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig

Spec = tuple


class MeshShape(NamedTuple):
    """Axis names and sizes of a mesh without devices (JAX's ``AbstractMesh``)."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]


def axis_names(mesh) -> tuple[str, ...]:
    if isinstance(mesh, MeshShape):
        return tuple(mesh.axis_names)
    return tuple(mesh.mesh_dim_names)


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """The batch / FSDP axes of the ``tp_sp`` layout: ``pod`` and ``data``."""
    return tuple(n for n in axis_names(mesh) if n in ("pod", "data"))


def make_rules(mesh, layout: str = "tp_sp"):
    """The :class:`~repro_torch.models.layers.MeshRules` of a ``DeviceMesh``:
    ``fsdp`` (ZeRO-3) takes every axis as a data/parameter-shard axis and no
    tensor axis; ``tp_sp`` takes ``pod``/``data`` as dp and ``model`` as tp."""
    from repro_torch.models.layers import MeshRules

    if layout == "fsdp":
        return MeshRules(mesh=mesh, dp=axis_names(mesh), tp=None)
    return MeshRules(mesh=mesh, dp=data_axes(mesh), tp="model")


def normalize(spec) -> Spec:
    """``spec`` with a one-name tuple entry as the name and an empty tuple
    as ``None`` (the form JAX's ``PartitionSpec`` keeps)."""
    def one(e):
        if isinstance(e, tuple):
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(one(e) for e in spec)


def _axis_size(sizes: Mapping[str, int], entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for e in entry:
            n *= sizes[e]
        return n
    return sizes[entry]


def _fits(shape, spec: Spec, sizes) -> bool:
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if dim % _axis_size(sizes, entry) != 0:
            return False
    return True


def _choose(shape, candidates: list[tuple], sizes) -> Spec:
    """First fully-divisible candidate; else the first candidate with its
    non-divisible axes stripped."""
    for cand in candidates:
        spec = tuple(cand[: len(shape)])
        if _fits(shape, spec, sizes):
            return normalize(spec)
    cand = candidates[0][: len(shape)]
    return normalize(tuple(e if shape[i] % _axis_size(sizes, e) == 0 else None
                           for i, e in enumerate(cand)))


def _spec_candidates(name: str, dp, tp) -> list[tuple]:
    """The ordered candidate table of parameter ``name`` (first = preferred)."""
    parts = name.split(".")
    leaf = parts[-1]
    none4 = [(None,) * 4]
    if leaf == "embed" and len(parts) == 1:
        return [(tp, dp), (None, dp), (None, None)]
    if leaf == "lm_head" and len(parts) == 1:
        return [(dp, tp), (dp, None), (None, None)]
    if "moe" in parts:
        if leaf == "router":
            return [(dp, None), (None, None)]
        if leaf in ("w_gate", "w_up"):
            # EP first; fall back to TP on the expert FFN dim (grok: E=8 < |tp|)
            return [(tp, dp, None), (None, dp, tp), (None, None, None)]
        if leaf == "w_down":
            return [(tp, None, dp), (None, tp, dp), (None, None, None)]
    if "attn" in parts or "shared_attn" in parts or "cross" in parts:
        if leaf in ("wq", "wk", "wv"):
            return [(dp, tp, None), (dp, None, tp), (dp, None, None), (None,) * 3]
        if leaf == "wo":
            return [(tp, None, dp), (None, tp, dp), (None, None, dp), (None,) * 3]
        if leaf in ("w_gate", "w_up", "w_in"):
            return [(dp, tp), (dp, None), (None, None)]
        if leaf == "w_down":
            return [(tp, dp), (None, dp), (None, None)]
        return none4
    if "mlp" in parts:
        if leaf == "w_down":
            return [(tp, dp), (None, dp), (None, None)]
        if leaf in ("w_gate", "w_up", "w_in"):
            return [(dp, tp), (dp, None), (None, None)]
    if "mamba" in parts:
        if leaf in ("w_z", "w_x"):
            return [(dp, tp), (dp, None), (None, None)]
        if leaf == "w_out":
            return [(tp, dp), (None, dp), (None, None)]
        if leaf in ("w_B", "w_C", "w_dt"):
            return [(dp, None), (None, None)]
        if leaf == "conv_w":
            return [(None, tp), (None, None)]
    return none4


def _shapes(params) -> dict[str, tuple[int, ...]]:
    """``{name: shape}`` of an ``nn.Module``'s parameters or of a mapping of
    names to tensors or shapes."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {n: tuple(p.shape) if hasattr(p, "shape") else tuple(p) for n, p in params.items()}


def param_specs(params, mesh, layout: str = "tp_sp") -> dict[str, Spec]:
    """``{parameter name: spec}`` for ``layout`` ``tp_sp`` or ``fsdp``.
    ``params`` is an ``LM`` (on the meta device for production shapes) or a
    mapping of names to tensors or shapes."""
    shapes = _shapes(params)
    sizes = mesh_sizes(mesh)
    if layout == "fsdp":
        return _fsdp_param_specs(shapes, mesh)
    dp, tp = data_axes(mesh), "model"
    return {n: _choose(s, _spec_candidates(n, dp, tp), sizes) for n, s in shapes.items()}


def _fsdp_param_specs(shapes: Mapping[str, tuple], mesh) -> dict[str, Spec]:
    """ZeRO-3: shard the first divisible dim over ALL mesh axes."""
    axes = axis_names(mesh)
    n_all = _axis_size(mesh_sizes(mesh), axes)
    out = {}
    for name, shape in shapes.items():
        spec = [None] * len(shape)
        for i, d in enumerate(shape):
            if d % n_all == 0 and d >= n_all:
                spec[i] = axes
                break
        out[name] = normalize(spec)
    return out


def train_state_specs(params, mesh, layout: str = "tp_sp"):
    """``(parameter specs, AdamWState specs)``: the moments shard like the
    parameters, ``step`` is replicated."""
    from repro_torch.optim.adamw import AdamWState

    ps = param_specs(params, mesh, layout)
    return ps, AdamWState(step=(), m=ps, v=dict(ps))


def batch_spec(mesh, layout: str = "tp_sp") -> Spec:
    """A ``[B, S]`` batch: B over the data axes (over every axis for fsdp)."""
    if layout == "fsdp":
        return normalize((axis_names(mesh), None))
    return normalize((data_axes(mesh), None))


def cache_specs(cache, cfg: ArchConfig, shape: ShapeConfig, mesh) -> list[dict[str, Spec]]:
    """Decode-cache specs, one dict a layer as ``models.decode.init_cache``.

    Attention caches ``k``/``v`` (and an encoder-decoder's ``cross_k`` /
    ``cross_v``) ``[B, T, Kv, hd]``: batch over dp when divisible, else the
    cache sequence dim over dp (long-context SP decode); kv heads over
    ``model``, else ``hd``.  Mamba ``ssd [B, H, ds, hd]``: batch over dp
    when divisible, heads over ``model``; ``conv [B, cw-1, di]``: di over
    ``model``."""
    sizes = mesh_sizes(mesh)
    dp = data_axes(mesh)
    dp_size = _axis_size(sizes, dp)
    batch_ok = shape.global_batch % dp_size == 0 and shape.global_batch >= dp_size
    bdp = dp if batch_ok else None

    def one(key: str, leaf) -> Spec:
        nd = leaf.ndim
        if key == "conv":  # [B, cw-1, di]
            cands = [(bdp, None, "model"), (None, None, "model"), (None,) * 3]
        elif key == "ssd":  # [B, H, ds, hd]
            cands = [(bdp, "model", None, None), (bdp, None, None, None), (None,) * 4]
        elif nd == 4:  # attention k/v [B, T, Kv, hd]
            if batch_ok:
                cands = [(dp, None, "model", None), (dp, None, None, "model"),
                         (dp, None, None, None), (None,) * 4]
            else:
                cands = [(None, dp, "model", None), (None, dp, None, "model"),
                         (None, dp, None, None), (None,) * 4]
        else:
            cands = [(None,) * nd]
        return _choose(tuple(leaf.shape), cands, sizes)

    return [{k: one(k, v) for k, v in layer.items()} for layer in cache]


# ----------------------------------------------------------------------------
# Specs as DTensor placements
# ----------------------------------------------------------------------------


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim named in entry ``d``, ``Replicate()`` elsewhere.  A tuple entry puts
    several mesh dims on one tensor dim, major to minor; its order must be
    the mesh's (DTensor shards in mesh-dim order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_names(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def spec_of(placements, mesh, ndim: int) -> Spec:
    """The spec of ``placements`` (the inverse of :func:`to_placements`): an
    axis name where one mesh dim shards a tensor dim, a tuple where several
    do.  Raises on a ``Partial`` placement."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    entries: list[list[str]] = [[] for _ in range(ndim)]
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            entries[p.dim % ndim].append(names[i])
        elif not isinstance(p, Replicate):
            raise ValueError(f"{p} has no spec")
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in entries)


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """``t`` (the whole tensor, the same on every rank) as a DTensor with
    ``spec``'s placements: each rank keeps its own shard, nothing moves."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, to_placements(spec, mesh), src_data_rank=None)


def set_parameter(model: nn.Module, name: str, value: torch.Tensor) -> None:
    """Replace parameter ``name`` (dotted) of ``model`` by ``value``,
    keeping its ``requires_grad``."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    old = getattr(mod, leaf)
    mod.register_parameter(leaf, nn.Parameter(value, requires_grad=old.requires_grad))


@torch.no_grad()
def distribute_params(model: nn.Module, mesh, specs: Mapping[str, Spec]) -> nn.Module:
    """Make every parameter of ``model`` a DTensor with its spec's
    placements, in place (each rank keeps its shard of the whole parameter
    it holds)."""
    for name, p in list(model.named_parameters()):
        set_parameter(model, name, distribute(p.detach(), mesh, specs[name]))
    return model


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``): a leaf of the
    ``shardings`` tree that ``CheckpointManager.restore`` takes."""
    mesh: Any
    spec: Spec


def named(mesh, specs):
    """``specs`` (a dict, NamedTuple or a spec) with every spec wrapped as a
    :class:`NamedSharding` on ``mesh``."""
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(named(mesh, s) for s in specs))
    if isinstance(specs, Mapping):
        return {k: named(mesh, s) for k, s in specs.items()}
    return NamedSharding(mesh, tuple(specs))
