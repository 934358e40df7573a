"""chip_smoke.py's serving and observability phases, the launcher's
``--continuous`` mode and ``examples/torch_serve_requests.py``, rehearsed on
the CPU at a small size (plain versions of the kernels; the launch counts a
card run reads are derived from each run and handed in)."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

from repro_torch import configs as tconfigs
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.data import synthetic
from repro_torch.data.block_store import build_block_store
from repro_torch.launch import serve as tserve
from repro_torch.models import init_params as init_lm

REPO = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture(scope="module")
def small():
    cs = _chip_smoke()
    table = synthetic.make_real_like_table("airline", num_records=300_000, seed=0)
    store = build_block_store(table, cs.RPB, device="cpu")
    return cs, table, store


def _run(cs, seen):
    def run(name, fn):
        assert name in cs.PHASE_KERNELS
        seen.append(name)
        return fn(), 0.0, {}
    return run


def test_chip_smoke_serving_phases_pass_on_a_small_cpu_store(small, monkeypatch):
    """serve_exemplar (its four loops and the real-clock run), serve_tiered,
    serve_aggregate and obs on the 300,000-record airline table: 16 queries
    on 4 slots, tier 0 of 8 blocks."""
    cs, table, store = small
    monkeypatch.setattr(cs, "SERVE_SLOTS", 4)
    from repro_torch.storage import TierStack as Stack

    queries = cs.make_wave(table.cards, 16, seed=0)
    batch = NeedleTailEngine(store, device="cpu").any_k_batch(queries)
    seen = []
    run = _run(cs, seen)
    se = cs.serve_exemplar_check(store, queries, batch, run, device="cpu")
    assert seen == ["serve_exemplar", "serve_exemplar_host", "serve_exemplar_drain"]
    ref = se.pop("ref")
    dev = se["serve_exemplar"]
    assert dev["ticks"] > 16 // 4 and 0.5 < dev["slot_occupancy"] <= 1.0
    assert dev["flushes"] >= 2 and dev["admission"]["refill_waves"] >= 1
    assert se["serve_exemplar_drain"]["flushes"] == 4
    assert se["real_clock"]["events"] == 0 and se["real_clock"]["wait_p99_s"] >= 0.0
    nb = Stack.block_nbytes(store)
    st = cs.serve_tiered_check(store, queries, ref, run, device="cpu", hbm_bytes=8 * nb)
    assert st["prefetch"]["issued"] > 0 and st["refits"] == st["ticks"] // cs.SERVE_RECALIBRATE_EVERY
    assert sum(st["launch_reasons"].values()) >= 16 // cs.SERVE_TIER_GROUP
    assert st["plan_qerror"] is not None
    sa = cs.serve_aggregate_check(store, store, queries, run, seed=0, device="cpu")
    plans = sa.pop("plans")
    reasons = [a["reason"] for a in sa["answers"]]
    assert reasons[:6] == ["ci"] * 6 and sa["cpu_bit_equal"] == 8
    assert sa["admission"]["refill_waves"] >= 1
    ob = cs.obs_check(store, queries, plans, run, device="cpu")
    assert ob["report"] == f"trace: {ob['events']} events, {16 + 8} completed requests"
    assert ob["dropped"] == 0 and ob["prometheus_lines"] > 20
    assert seen[3:] == ["serve_tiered", "serve_aggregate", "obs"]
    # the checks fail where they should
    broken = NeedleTailEngine(store, device="cpu").any_k_batch(queries[1:] + queries[:1])
    with pytest.raises(AssertionError):
        cs.serve_tiered_check(store, queries, broken, run, device="cpu", hbm_bytes=8 * nb)
    bad = [dict(p, stream=p["stream"][1:] + p["stream"][:1]) for p in plans]
    with pytest.raises(AssertionError, match="solo run"):
        cs.obs_check(store, queries, bad, run, device="cpu")
    with pytest.raises(AssertionError, match="expected"):
        cs.check_launches({"density_combine_batch": 3, "theta_stats_batch": 5},
                          {"density_combine_batch": 2, "theta_stats_batch": 5}, "serve_exemplar")


def _lm_run(cs, cfg):
    """``run`` for the LM phases: the launches a card would count, from the
    prefills of the runs ``fn`` made."""
    want = cs.lm_layer_counts(cfg)

    def run(name, fn):
        assert name in cs.PHASE_KERNELS
        out = fn()
        n = sum(cs.lm_prefills(e) for e, _, _ in out.values())
        return out, 0.5, {**dict.fromkeys(cs.KERNELS, 0), **{k: v * n for k, v in want.items()}}
    return run


def test_chip_smoke_lm_continuous_phases_pass_on_reduced_cpu_models():
    """serve_lm_continuous on reduced zamba2 (the launcher's traffic and the
    join run) and serve_lm_continuous_swa on a narrow gemma3 at D = 240
    whose window of 16 the first prompt passes, so the joiners' rings
    wrap."""
    cs = _chip_smoke()
    tcfg = tconfigs.reduced(tconfigs.get_config(cs.LM_ARCH))
    model = init_lm(tcfg, 0, device="cpu")
    res = cs.lm_continuous_check(model, cs.LM_JOIN, 0, _lm_run(cs, tcfg), "serve_lm_continuous",
                                 cs.SERVE_TRAFFIC["launcher"])
    assert res["traffic"]["streams"]["tokens_equal"] == res["traffic"]["streams"]["tokens"] > 0
    assert res["join"]["streams"]["near_ties"] == 0
    assert res["join"]["joiner_vs_solo"]["tokens_equal"] == cs.LM_JOIN["max_new"][1]
    assert res["join"]["joiners_at_ticks"][0] == 1 and len(res["join"]["joiners_at_ticks"]) == 2
    assert res["prefills"] == res["traffic"]["kernel"]["prefills"] + 3
    assert res["traffic"]["kernel"]["tokens"] == 8 * 16
    scfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(cs.SWA_ARCH)),
                               d_model=480, num_heads=2, num_kv_heads=1)
    smodel = init_lm(scfg, 0, device="cpu")
    join = {"plens": (24, 24, 11), "max_new": (12, 4, 4), "max_seq": 48}
    assert join["plens"][0] > scfg.attn_window
    res = cs.lm_continuous_check(smodel, join, 0, _lm_run(cs, scfg), "serve_lm_continuous_swa")
    assert "traffic" not in res and res["prefills"] == 3
    assert res["join"]["streams"]["tokens_equal"] == sum(join["max_new"])
    with pytest.raises(AssertionError, match="launches"):
        cs.lm_continuous_check(smodel, join, 0, lambda name, fn: (fn(), 0.5, {
            **dict.fromkeys(cs.KERNELS, 0), "flash_attention": 1}), "serve_lm_continuous_swa")


def test_serve_launcher_continuous_runs_on_the_cpu(capsys):
    n = tserve.main(["--arch", "zamba2-7b", "--requests", "5", "--max-new", "4", "--slots", "2",
                     "--max-seq", "48", "--device", "cpu", "--continuous"])
    assert n == 5
    assert "continuous on cpu: 5 requests, 20 tokens" in capsys.readouterr().out


def test_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_serve_requests", REPO / "examples" / "torch_serve_requests.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--device", "cpu", "--records", "60000"])
    assert [len(out[k]) for k in ("exemplar", "aggregate", "lm")] == [12, 4, 6]
    text = capsys.readouterr().out
    assert "exemplar rows == solo any_k" in text and "trace: " in text
    assert all(r.reason == "ci" for r in out["aggregate"])
    assert np.all([len(r.out_tokens) == 8 for r in out["lm"]])
