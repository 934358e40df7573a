"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
its entry points default to the card and refuse to fall back to the CPU, and
its kernels refuse tensors they have no kernel for."""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)", re.MULTILINE)


def _port_modules() -> list[str]:
    mods = []
    for p in PORT.rglob("*.py"):
        parts = p.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(mods)


def test_importing_every_port_module_leaves_jax_and_repro_out():
    mods = _port_modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) >= 28
    assert {'repro_torch.core.predicates', 'repro_torch.core.forward_optimal',
            'repro_torch.core.hybrid', 'repro_torch.core.estimators',
            'repro_torch.core.online_agg', 'repro_torch.core.groupby',
            'repro_torch.core.baselines', 'repro_torch.serving.admission',
            'repro_torch.storage', 'repro_torch.storage.prefetch'} <= set(mods)
    assert {'repro_torch.storage.tiers', 'repro_torch.storage.policy',
            'repro_torch.storage.calibration', 'repro_torch.storage.residency',
            'repro_torch.storage.compact', 'repro_torch.core.plan_ledger',
            'repro_torch.data.append'} <= set(mods)
    assert {'repro_torch.core.block_cache', 'repro_torch.kernels.ops',
            'repro_torch.kernels.window_scan', 'repro_torch.kernels.flash_attention',
            'repro_torch.kernels.ssd_chunk', 'repro_torch.configs', 'repro_torch.models.lm',
            'repro_torch.models.decode', 'repro_torch.serving.engine',
            'repro_torch.launch.serve', 'repro_torch.launch.steps',
            'repro_torch.core.sharded', 'repro_torch.launch.mesh'} <= set(mods)


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_imports_no_jax_or_reference(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_forbidden_import_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.kernels import ops", "  from repro import compat"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import engine",
                 "# the JAX package: repro.core.engine"):
        assert not _FORBIDDEN.search(line), line


def _tiny_table():
    from repro_torch.data.block_store import Table

    rng = np.random.default_rng(0)
    return Table(
        dims=rng.integers(0, 2, (64, 2)).astype(np.int32),
        measures=rng.normal(size=(64, 1)).astype(np.float32),
        cards=np.asarray([2, 2]),
    )


def _entry_points():
    from repro_torch import resolve_device
    from repro_torch.convert import store_from_reference
    from repro_torch.core.baselines import build_bitmap_index
    from repro_torch.core.density_map import build_density_maps
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.cost_model import make_cost_model
    from repro_torch.data.block_store import build_block_store
    from repro_torch.storage import Tier, TierStack, make_tier_stack

    t = _tiny_table()
    cpu_store = build_block_store(t, 16, device="cpu")
    arrays = {
        "dims": cpu_store.dims.numpy(), "measures": cpu_store.measures.numpy(),
        "valid_rows": cpu_store.valid_rows.numpy(),
        "densities": cpu_store.index.densities.numpy(),
        "sorted_block_ids": cpu_store.index.sorted_block_ids.numpy(),
        "sorted_densities": cpu_store.index.sorted_densities.numpy(),
        "attr_offsets": cpu_store.index.vocab.attr_offsets,
        "attr_cards": cpu_store.index.vocab.attr_cards,
    }
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM, init_cache, init_params
    from repro_torch.serving import ServeEngine

    lm_cfg = reduced(get_config("zamba2-7b"))
    cpu_lm = init_params(lm_cfg, 0, device="cpu")
    lm_tree = {"embed": cpu_lm.embed.numpy()}
    return {
        "init_params": lambda: init_params(lm_cfg),
        "LM": lambda: LM(lm_cfg),
        "init_cache": lambda: init_cache(lm_cfg, 1, 8),
        "ServeEngine": lambda: ServeEngine(lm_cfg, cpu_lm),
        "lm_params_from_reference": lambda: lm_params_from_reference(lm_tree, lm_cfg),
        "launch.serve.main": lambda: serve.main(["--arch", "zamba2-7b", "--requests", "1"]),
        "resolve_device": lambda: resolve_device(),
        "build_density_maps": lambda: build_density_maps(t.dims, t.cards, 16),
        "build_block_store": lambda: build_block_store(t, 16),
        "store_from_reference": lambda: store_from_reference(arrays, 16, 64),
        "NeedleTailEngine": lambda: NeedleTailEngine(cpu_store),
        "store.to": lambda: cpu_store.to("cuda"),
        "make_host_mesh": lambda: make_host_mesh(),
        "build_bitmap_index": lambda: build_bitmap_index(t.dims, t.cards),
        "make_tier_stack": lambda: make_tier_stack(None, None),
        "TierStack": lambda: TierStack([Tier("hbm", None, make_cost_model("ssd"), device=True)]),
    }


@pytest.mark.parametrize(
    "name", ["resolve_device", "build_density_maps", "build_block_store",
             "store_from_reference", "NeedleTailEngine", "store.to", "init_params", "LM",
             "init_cache", "ServeEngine", "lm_params_from_reference", "launch.serve.main",
             "make_host_mesh", "build_bitmap_index", "make_tier_stack", "TierStack"],
)
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_engine_on_cpu_runs_only_when_asked_and_checks_the_store_device():
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.data.block_store import build_block_store

    store = build_block_store(_tiny_table(), 16, device="cpu")
    eng = NeedleTailEngine(store, device="cpu")
    assert eng.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        NeedleTailEngine(store, device="meta")


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    """No fallback: a tensor on neither the CPU nor CUDA raises instead of
    silently running the plain version."""
    from repro_torch.kernels.density_combine import (
        density_combine, density_combine_batch, density_combine_batch_sharded,
    )
    from repro_torch.kernels.plan_wave import block_gather
    from repro_torch.kernels.theta_stats import theta_stats, theta_stats_batch
    from repro_torch.kernels.window_scan import prefix_sum

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        density_combine_batch(torch.empty((4, 8), device=meta),
                              torch.empty((2, 2), dtype=torch.int32, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        theta_stats_batch(torch.empty((2, 8), device=meta), torch.empty((2, 8), device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        block_gather(torch.empty((4, 3, 2), dtype=torch.int32, device=meta),
                     torch.empty((2,), dtype=torch.int32, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        density_combine(torch.empty((4, 8), device=meta),
                        torch.empty((2,), dtype=torch.int32, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        theta_stats(torch.empty((8,), device=meta), torch.empty((3,), device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        prefix_sum(torch.empty((2, 8), device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        density_combine_batch_sharded(torch.empty((4, 8), device=meta),
                                      torch.empty((2, 2), dtype=torch.int32, device=meta))


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """A missing toolkit is an error, never a reason to use the plain path."""
    from repro_torch.kernels import _lib

    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    build_dir = REPO / "build" / "no-such-build-dir"
    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setattr(_lib, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_lib.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.load()
    assert not build_dir.exists()


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_without_cuda_fails_and_prints_no_result(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run(
        [sys.executable, str(script), "--records", "1000"], cwd=script.parent,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
