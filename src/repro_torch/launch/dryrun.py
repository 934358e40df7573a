"""Production dry run: run every (arch × shape × mesh) cell once on a fake
world of 256 or 512 ranks and record per-device memory, FLOP and collective
statistics, in the reference's artifact schema.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 512 forced host devices and reads XLA's memory and
cost analyses and its optimised HLO (``repro/launch/hlo_analysis.py``).  The
port has no compiler to ask and no HLO, so it runs the step itself, as rank
0 of a ``fake`` process group (whose collectives move nothing) under
``FakeTensorMode`` (tensors with shapes and no memory): the parameters,
moments, batch and caches are DTensors placed by the sharding tables on
``make_production_mesh`` (``device_type="cpu"``: fake tensors need no card),
and the step runs once with ``impl="plain"``, the reference's ``"xla"``
default.  What it records:

* ``memory.argument_bytes_per_device``: the exact sum of rank 0's local
  shard bytes of the step's arguments; ``output_bytes_per_device`` and
  ``alias_bytes_per_device`` (outputs that are arguments updated in place)
  likewise; ``peak_bytes_per_device`` from ``torch.distributed._tools.
  mem_tracker.MemTracker`` over the step, and ``temp`` = peak − argument;
* ``analyzer.flops_per_device``: the FLOPs of rank 0's local ops
  (``torch.utils.flop_counter``'s formulas, counted below DTensor's dispatch,
  so one device's share, not the global product);
* ``analyzer.collective_bytes_per_device`` and ``per_collective`` (count and
  bytes a type): the collectives DTensor and the step issue, counted by
  ``CommDebugMode`` and sized at dispatch with the reference's wire rule
  (all-reduce 2·|out|, all-gather |out|, reduce-scatter |in|, all-to-all
  |out|);
* ``analyzer.hbm_bytes_per_device``: ``None``, there is no HLO walker (the
  reference's ``hlo_analysis`` has no counterpart in the port).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
# per-device wire bytes of one collective, from its input and output bytes
_WIRE = {"all_reduce": lambda i, o: 2 * o, "all_gather_into_tensor": lambda i, o: o,
         "reduce_scatter_tensor": lambda i, o: i, "all_to_all_single": lambda i, o: o}


# the in-place c10d ops (torch.distributed's own calls) under their functional names
_C10D = {"c10d::allreduce_": "all_reduce", "c10d::allgather_": "all_gather_into_tensor",
         "c10d::_allgather_base_": "all_gather_into_tensor",
         "c10d::reduce_scatter_": "reduce_scatter_tensor",
         "c10d::_reduce_scatter_base_": "reduce_scatter_tensor",
         "c10d::alltoall_base_": "all_to_all_single"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _flat(x) -> list:
    """The tensors of ``x``: a tensor, or (nested) lists and tuples of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return []


def _tensors(tree) -> list:
    """The tensors of ``tree``: a module's state, dicts, lists and tuples
    walked."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict(keep_vars=True).values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def local_bytes(tree) -> int:
    """The bytes this rank holds of every tensor in ``tree`` (a DTensor's
    local shard, a tensor whole)."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def _storages(tree) -> set:
    """The local storages of the tensors in ``tree`` (to find aliases)."""
    return {_local(t).untyped_storage()._cdata for t in _tensors(tree)}


class DeviceCounter(TorchDispatchMode):
    """A dispatch mode counting one device's work: the FLOPs of the ops on
    local tensors (an op on DTensors passes through to DTensor, whose local
    ops come back here) and the bytes of each collective."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: dict[str, dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        qualified = packet._qualified_op_name
        name = _C10D.get(qualified, packet.__name__)
        if qualified.split("::")[0] in ("_c10d_functional", "c10d") and name in _WIRE:
            if qualified.startswith("c10d::"):  # torch.distributed's in-place ops: lists
                i = sum(_nbytes(t) for t in _flat(args[1] if name != "all_reduce" else args[0]))
                o = sum(_nbytes(t) for t in _flat(args[0]))
            else:
                i, o = _nbytes(args[0]), sum(_nbytes(t) for t in _flat(out))
            c = self.collectives.setdefault(name, {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += _WIRE[name](i, o)
        return out


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a ``fake`` process group of ``n`` ranks (its collectives
    move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def measure(run, arguments, mode=None) -> tuple[dict, dict, object]:
    """Run ``run()`` once under ``mode`` (a FakeTensorMode; real tensors
    when ``None``) with the counters on; returns ``(memory, analyzer,
    outputs)``."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    counter = DeviceCounter()
    tracker = MemTracker()
    tracker.track_external(*[t for t in _tensors(arguments)])
    with mode or contextlib.nullcontext(), tracker, CommDebugMode() as comm, counter:
        out = run()
    arg = local_bytes(arguments)
    peak = max(sum(v for k, v in snap.items() if k == "Total")
               for snap in tracker.get_tracker_snapshot("peak").values())
    alias = _storages(arguments)
    out_b = local_bytes(out)
    alias_b = sum(local_bytes(t) for t in _tensors(out) if _storages(t) & alias)
    peak = max(peak, arg)
    memory = {
        "argument_bytes_per_device": arg,
        "output_bytes_per_device": out_b,
        "temp_bytes_per_device": peak - arg,
        "alias_bytes_per_device": alias_b,
        "peak_bytes_per_device": peak,
    }
    per = {k: dict(v) for k, v in sorted(counter.collectives.items())}
    counts: dict[str, int] = {}
    for k, v in comm.get_comm_counts().items():
        q = str(k).replace(".", "::", 1)
        name = _C10D.get(q, q.split("::")[-1])
        counts[name] = counts.get(name, 0) + int(v)
    for name, c in per.items():  # CommDebugMode's count beside the dispatch count
        c["comm_debug_count"] = counts.get(name, 0)
    analyzer = {
        "flops_per_device": counter.flops,
        "hbm_bytes_per_device": None,
        "collective_bytes_per_device": sum(c["bytes"] for c in per.values()),
        "per_collective": per,
        "top_collectives": sorted(((n, c["bytes"]) for n, c in per.items()),
                                  key=lambda x: -x[1])[:8],
        "warnings": 0,
    }
    return memory, analyzer, out


def build_cell(cfg, shape, mesh, layout: str, remat=True, variant_kw: dict | None = None,
               mode=None):
    """``(run, arguments, mode)`` for one cell: the step closed over its
    sharded fake arguments (everything placed by the sharding tables on
    ``mesh``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import sharding as S
    from repro_torch.launch import specs as SP
    from repro_torch.launch import steps as ST

    mode = mode or FakeTensorMode()
    variant_kw = variant_kw or {}
    rules = S.make_rules(mesh, layout) if mesh is not None else None
    specs = SP.input_specs(cfg, shape, mode=mode)
    model = SP.abstract_model(cfg, torch.bfloat16, mode)
    with mode:
        if rules is not None:  # a decode cell places its parameters by tp_sp, as the reference
            table = "tp_sp" if shape.kind == "decode" else layout
            S.distribute_params(model, mesh, S.param_specs(model, mesh, table))
        if shape.kind == "train":
            state = ST.make_train_state(model, torch.bfloat16)
            batch = specs
            if rules is not None:
                bspec = S.batch_spec(mesh, layout)
                batch = {k: S.distribute(v, mesh, bspec + (None,) * (v.dim() - 2))
                         for k, v in specs.items()}
            step = ST.make_train_step(cfg, remat=remat, rules=rules, **variant_kw)
            return (lambda: step(state, batch)), (state, batch), mode
        if shape.kind == "prefill":
            batch = specs
            if rules is not None:
                bspec = S.batch_spec(mesh, layout)
                batch = {k: S.distribute(v, mesh, bspec + (None,) * (v.dim() - 2))
                         for k, v in specs.items()}
            step = ST.make_prefill_step(cfg, "plain", max_seq=shape.seq_len, rules=rules,
                                        **variant_kw)
            return (lambda: step(model, batch)), (model, batch), mode
        cache, tokens, pos = specs["cache"], specs["tokens"], 0
        if rules is not None:
            cspecs = S.cache_specs(cache, cfg, shape, mesh)
            cache = [{k: S.distribute(v, mesh, cspecs[i][k]) for k, v in layer.items()}
                     for i, layer in enumerate(cache)]
            tok_spec = (rules.dp,) if shape.global_batch > 1 else (None,)
            tokens = S.distribute(tokens, mesh, S.normalize(tok_spec))
        step = ST.make_decode_step(cfg, rules=rules)
        # pos is a host int: the step writes one cache slot; the last one
        # attends over the whole cache
        pos = shape.seq_len - 1
        return (lambda: step(model, cache, tokens, pos)), (model, cache, tokens), mode


def run_cell(arch: str, shape_name: str, mesh_kind: str, remat=True, suffix: str = "",
             variant_kw: dict | None = None, layout: str = "tp_sp", *, cfg=None,
             mesh=None) -> dict:
    """One cell's artifact.  ``mesh=None`` starts a fake world of the
    production mesh's size (256, or 512 for ``mesh_kind="multi"``) for the
    cell; a given ``DeviceMesh`` (over a world the caller started) and a
    given ``cfg`` (a reduced config) are for tests."""
    from repro_torch.configs import SHAPES, get_config, shape_supported
    from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh

    cfg = cfg or get_config(arch)
    if layout == "auto":  # the reference's measured layout law
        layout = "tp_sp" if cfg.moe else "fsdp"
    shape = SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        result["status"] = why
        return result
    with contextlib.ExitStack() as stack:
        if mesh is None:
            sizes = PRODUCTION_MESHES[mesh_kind == "multi"][0]
            stack.enter_context(fake_world(int(torch.tensor(sizes).prod())))
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
        t0 = time.time()
        run, arguments, mode = build_cell(cfg, shape, mesh, layout, remat, variant_kw)
        t_build = time.time() - t0
        memory, analyzer, _ = measure(run, arguments, mode)
        t_run = time.time() - t0 - t_build
        print(f"[{arch} | {shape_name} | {mesh_kind}] memory:", memory)
        print(f"[{arch} | {shape_name} | {mesh_kind}] flops/device:", analyzer["flops_per_device"])
        result.update(
            status="ok",
            lower_s=round(t_build, 1),
            compile_s=None,
            run_s=round(t_run, 1),
            memory=memory,
            cost_raw=None,
            analyzer=analyzer,
            num_devices=mesh.size(),
            remat=remat,
            layout=layout,
            notes=("fake world + FakeTensorMode, impl='plain'; no compiler: compile_s and "
                   "cost_raw are None; hbm_bytes_per_device is None (no HLO walker)"),
        )
    return result


def main(argv=None):
    from repro_torch.configs import SHAPES, list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--layout", default="tp_sp", choices=["tp_sp", "fsdp", "auto"])
    ap.add_argument("--remat-policy", default=None, choices=[None, "dots"])
    ap.add_argument("--suffix", default="", help="artifact filename suffix (perf variants)")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = ([(a, s) for a in list_archs() for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    failures = 0
    for arch, shape in cells:
        for mesh_kind in meshes:
            name = f"{arch}__{shape}__{mesh_kind}{args.suffix}"
            path = out_dir / f"{name}.json"
            if path.exists():
                print(f"[skip existing] {name}")
                continue
            t0 = time.time()
            try:
                res = run_cell(arch, shape, mesh_kind,
                               remat=(args.remat_policy or not args.no_remat),
                               layout=args.layout)
            except Exception as e:  # one cell's failure is recorded; the sweep goes on
                traceback.print_exc()
                res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "status": f"FAIL: {type(e).__name__}: {e}"}
                failures += 1
            res["wall_s"] = round(time.time() - t0, 1)
            path.write_text(json.dumps(res, indent=2))
            print(f"[done] {name}: {res.get('status')} ({res['wall_s']}s)")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
