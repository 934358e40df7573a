"""The port's dry run: fake worlds, per-device counts, the reference's
artifact schema.

* ``tests/test_system.py:65`` mirrored: importing the mesh and dry-run
  modules starts neither CUDA nor a process group;
* ``tests/test_distributed.py:143`` mirrored: the port has no
  ``hlo_analysis`` (there is no HLO to walk); its per-device FLOP counter
  counts that test's 12-step scan as ``12·2·64³``;
* ``run_cell`` for reduced yi-9b ``train_4k`` on a fake ``(4, 2)`` world:
  FLOPs per device are the unsharded step's count / 8, the argument bytes
  are the sum of the local shards the specs give, and the artifact has the
  reference's keys;
* the engine dry run at a small λ on a fake world of 8 writes its artifact;
* ``make_production_mesh`` on fake worlds of 256 and 512 (and refusing 8);
  ``input_specs`` and ``abstract_train_state`` against the reference's
  shapes;
* ``chip_smoke.py``'s sharded LM phases (lm_sharded, lm_sharded_ranks,
  dryrun) rehearsed on reduced models on the CPU: a gloo world of one, then
  four gloo ranks of the script, each probing the collectives DTensor issues.
"""
import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import jax

from repro.configs import get_config as jget_config
from repro.launch.specs import abstract_train_state as jabstract_train_state
from repro.launch.specs import input_specs as jinput_specs
from repro_torch.configs import SHAPES, get_config, list_archs, reduced
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as DR
from repro_torch.launch import dryrun_engine as DE
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import abstract_model

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s", "memory", "cost_raw",
            "analyzer", "num_devices", "remat", "layout"}
MEMORY_KEYS = {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "alias_bytes_per_device", "peak_bytes_per_device"}
ANALYZER_KEYS = {"flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device",
                 "per_collective", "top_collectives", "warnings"}


def test_dryrun_entry_importable_without_devices():
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.dryrun_engine\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not dist.is_initialized()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


def test_no_hlo_analysis_and_the_scan_counts_12_steps():
    assert importlib.util.find_spec("repro_torch.launch.hlo_analysis") is None
    x, w = torch.randn(64, 64), torch.randn(12, 64, 64)
    counter = DR.DeviceCounter()
    with counter:
        c = x
        for wi in w:
            c = torch.tanh(c @ wi)
    assert counter.flops == 12 * 2 * 64 * 64 * 64
    assert counter.collectives == {}


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_over_a_fake_world_of_its_size(multi):
    n = 512 if multi else 256
    with DR.fake_world(n):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        assert tuple(mesh.shape) == ((2, 16, 16) if multi else (16, 16))
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi else ("data", "model"))
    with DR.fake_world(8), pytest.raises(ValueError, match="world of"):
        make_production_mesh(multi_pod=multi, device_type="cpu")
    with pytest.raises(RuntimeError, match="initialised world"):
        make_production_mesh(multi_pod=multi, device_type="cpu")


def _np_dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_and_train_state_have_the_reference_shapes(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        ref = jinput_specs(jcfg, SHAPES[name])
        mine = SP.input_specs(cfg, SHAPES[name])
        assert set(mine) == set(ref)
        for k, v in mine.items():
            if k == "cache":
                period = len(cfg.layer_pattern)
                cycled = cfg.num_layers // period * period
                for i, layer in enumerate(v):
                    node = ref[k]["cycles"][i % period] if i < cycled else ref[k]["rest"][i - cycled]
                    for key, leaf in layer.items():
                        r = ref[k]["cross"][key[-1]] if key.startswith("cross_") else node[key]
                        assert tuple(leaf.shape) == tuple(r.shape[1:]), (i, key)
                        assert _np_dtype(leaf) == str(r.dtype), (i, key)
                continue
            assert tuple(v.shape) == tuple(ref[k].shape) and _np_dtype(v) == str(ref[k].dtype), k
    st, jst = SP.abstract_train_state(cfg), jabstract_train_state(jcfg)
    n_params = sum(p.numel() for p in st.model.parameters())
    assert n_params == sum(x.size for x in jax.tree.leaves(jst.params))
    assert {_np_dtype(p) for p in st.opt.m.values()} == {"bfloat16"}
    assert sum(m.numel() for m in st.opt.m.values()) == n_params
    assert tuple(st.step.shape) == tuple(jst.step.shape) == ()


def _expected_argument_bytes(cfg, mesh_shape, coord, shape) -> int:
    """Rank ``coord``'s bytes of the bf16 parameters and both moments, the
    two int32 steps and its rows of the int32 tokens and labels."""
    mesh = S.MeshShape(("data", "model"), mesh_shape)
    sizes = S.mesh_sizes(mesh)
    model = abstract_model(cfg, torch.bfloat16)
    total = 0
    for name, spec in S.param_specs(model, mesh).items():
        dims = list(dict(model.named_parameters())[name].shape)
        for d, entry in enumerate(spec):
            for axis in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                w = -(-dims[d] // sizes[axis])
                dims[d] = max(0, min(w, dims[d] - coord[axis] * w))
        total += 3 * 2 * int(torch.tensor(dims).prod())
    rows = shape.global_batch // sizes["data"]
    return total + 2 * 4 + 2 * rows * shape.seq_len * 4


def test_run_cell_on_a_fake_4x2_world_counts_one_devices_share():
    from torch.distributed.device_mesh import DeviceMesh

    cfg = reduced(get_config("yi-9b"))
    shape = SHAPES["train_4k"]
    with DR.fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2), mesh_dim_names=("data", "model"))
        res = DR.run_cell("yi-9b", "train_4k", "single", cfg=cfg, mesh=mesh)
        run, args, mode = DR.build_cell(cfg, shape, None, "tp_sp")
        _, whole, _ = DR.measure(run, args, mode)
    assert REF_KEYS <= set(res) and res["status"] == "ok" and res["num_devices"] == 8
    assert MEMORY_KEYS == set(res["memory"]) and ANALYZER_KEYS == set(res["analyzer"])
    an = res["analyzer"]
    assert an["flops_per_device"] * 8 == whole["flops_per_device"] > 0
    assert whole["collective_bytes_per_device"] == 0
    assert res["memory"]["argument_bytes_per_device"] == _expected_argument_bytes(
        cfg, (4, 2), {"data": 0, "model": 0}, shape)
    mem = res["memory"]
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes_per_device"] > 0
    per = an["per_collective"]
    assert {"all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"} <= set(per)
    for c in per.values():  # the dispatch count is CommDebugMode's
        assert c["count"] == c["comm_debug_count"] > 0 and c["bytes"] > 0
    assert an["collective_bytes_per_device"] == sum(c["bytes"] for c in per.values())
    assert an["hbm_bytes_per_device"] is None


@pytest.mark.parametrize("planner", ["sort", "bisect"])
def test_engine_dry_run_writes_its_artifact(tmp_path, planner):
    DE.main(["--lam", str(8 * 512), "--world", "8", "--planner", planner,
             "--out", str(tmp_path)])
    res = json.loads((tmp_path / "needletail-engine__anyk__single.json").read_text())
    assert res["status"] == "ok" and res["num_devices"] == 8
    assert res["params"]["lam_local"] == 512 and res["params"]["planner"] == planner
    assert res["memory"]["argument_bytes_per_device"] == DE.NUM_ROWS * 512 * 4
    per = res["analyzer"]["per_collective"]
    # two-prong gathers [1, 512 / 64] f32 group sums from 8 ranks; the HT terms
    # all-reduce 2 floats
    assert per["all_gather_into_tensor"]["count"] >= 1
    assert per["all_reduce"]["count"] >= 1
    if planner == "sort":  # [1, 64 + 64] int32 frontiers of 8 ranks + the group sums
        assert per["all_gather_into_tensor"]["bytes"] == 8 * 128 * 4 + 8 * 8 * 4


def test_chip_smoke_sharded_lm_phases_pass_on_reduced_cpu_models():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    seen = []

    def run(name, fn):
        assert name in cs.PHASE_KERNELS
        seen.append(name)
        return fn(), 0.5, dict.fromkeys(cs.KERNELS, 0)

    launches = {}
    res = cs.sharded_lm_phases(argparse.Namespace(seed=0, profile=False), "cpu", launches,
                               plan=cs.shard_plan("cpu", small=True), run=run)
    assert seen == ["lm_sharded_train", "lm_sharded_train", "lm_sharded_plain", "lm_sharded",
                    "dryrun"]
    assert set(res["lm_sharded"]["train"]) == {"plain", "tp_sp", "fsdp"}
    assert res["lm_sharded"]["serve"]["streams"]["tokens_equal"] == 4 * 4
    ranks = res["lm_sharded_ranks"]
    assert set(ranks["probe"].values()) == {"ok"} and len(ranks["ranks"]) == cs.SHARD_RANKS
    for r in ranks["ranks"]:
        for layout in ("tp_sp", "fsdp"):
            coll = r["train"][layout]["collectives"]
            assert coll["all_gather_into_tensor"]["count"] > 0, coll
    assert set(res["dryrun"]) == {"dryrun", "dryrun_engine"}
    assert res["dryrun"]["dryrun"]["num_devices"] == 256
