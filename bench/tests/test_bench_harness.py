"""Whole runs of the harness on the CPU at tiny sizes, with the program sound
and with faults planted in its timed path."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from bench import harness
from bench.tests.conftest import ROOT, TINY

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(bench, workload, trace=False, seconds=0.5, seed=2**31 + 7, grace_s=60.0):
    # the CPU's plain kernels serve a tiny table: a gentle rate, and time to answer
    return harness.run_cell(bench, workload, seed, seconds, trace, "cpu", time.monotonic(),
                            TINY, grace_s=grace_s, cell_params={"rate_per_s": 200})


@pytest.mark.parametrize("workload", ["synth-browse-open", "synth-sample-closed"])
def test_a_sound_run_is_correct(bench, workload):
    res = run(bench, workload)
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    names = {m["name"] for m in bench["end_to_end"]
             if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == names
    assert all(c["value"] <= c["limit"] for c in res["check"].values())


def test_a_traced_run_reads_the_host_layers(bench):
    res = run(bench, "synth-browse-open", trace=True)
    assert res["correct"]
    assert {"plan_ms.browse", "fetch_ms.browse", "rows_read_per_record.browse",
            "admission_wait_ms.browse"} <= set(res["metrics"])
    # no device here: the device metrics find nothing and are left out
    assert "device_idle_pct.browse" not in res["metrics"] and "busy_s" not in res["device"]


def _patched(monkeypatch, module, name, make):
    monkeypatch.setattr(module, name, make(getattr(module, name)))


def test_an_altered_answer_is_caught(bench, monkeypatch):
    import repro_torch.core.multi_query as mq

    def make(orig):
        def wave_records(*a, **kw):
            out = orig(*a, **kw)
            blk, row, meas = out[0]
            if meas.size:
                meas = meas.copy()
                meas[0, 0] += 1.0
            return [(blk, row, meas)] + out[1:]
        return wave_records

    _patched(monkeypatch, mq, "_wave_records", make)
    res = run(bench, "synth-browse-open")
    assert not res["correct"] and res["check"]["records_off"]["value"] > 0


def test_half_the_wave_left_out_is_caught(bench, monkeypatch):
    import repro_torch.core.multi_query as mq

    def make(orig):
        def execute(engine, active, wave_blocks, touched, touched_set):
            half = (len(active) + 1) // 2
            return orig(engine, active[:half], wave_blocks[:half], touched, touched_set)
        return execute

    _patched(monkeypatch, mq, "_execute_wave", make)
    res = run(bench, "synth-sample-closed", grace_s=2.0)
    # the left-out half never reads: lost, or answered with plans the rounds forbid
    assert not res["correct"] and res["failed"] > 0


def test_a_round_that_keeps_its_state_is_caught(bench, monkeypatch):
    import repro_torch.core.multi_query as mq

    # the exclusions never grow: each refill round plans the blocks it read
    _patched(monkeypatch, mq, "apply_chosen", lambda orig: lambda excl, *a: excl)
    res = run(bench, "synth-browse-open")
    assert not res["correct"] and res["check"]["plans_off"]["value"] > 0


def test_the_harness_loads_no_jax():
    code = ("import json, sys, time; sys.path[:0] = [%r, %r];"
            "from bench import harness; from bench.tests.conftest import TINY;"
            "b = json.load(open(%r));"
            "harness.run_cell(b, 'synth-sample-closed', 5, 0.3, True, 'cpu', time.monotonic(),"
            " TINY, cell_params={'rate_per_s': 200});"
            "print(json.dumps(harness.forbidden_modules()))"
            % (str(ROOT), str(ROOT / "src"), str(ROOT / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_modules_compares_whole_top_level_names():
    loaded = ["repro_torch", "repro_torch.core.engine", "reprolike", "numpy"]
    assert harness.forbidden_modules(loaded) == []
    assert harness.forbidden_modules(loaded + ["jax.numpy", "repro.core"]) == ["jax", "repro"]


def _cli(cwd, timeout=120):
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "synth-sample-closed",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_refuses_without_a_card():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_configs_hold_what_the_benchmark_names(bench):
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and (ROOT / "bench" / "layouts" /
                                             f"{cfg['layout']}.py").exists()
        assert len(cfg["cards"]) == len(cfg["dims"]) == len(cfg["values"])
        assert all(max(v) < card for v, card in zip(cfg["values"], cfg["cards"]))
    for w in bench["workloads"]:
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in bench["per_layer"]:
        mod = harness.load_module("metrics", m["name"])
        assert callable(mod.read)


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(bench, card):
    res = harness.run_cell(bench, "synth-browse-open", 11, 0.5, True, card, time.monotonic(),
                           TINY)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert np.isfinite(res["metrics"]["plan_kernels_roofline.browse"]["value"])
