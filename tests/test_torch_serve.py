"""The port's ``ServeEngine`` and serving launcher against the reference's, on
the CPU.

Reduced zamba2-7b, parameters carried across from the reference, the
launcher's traffic (``repro/launch/serve.py``: 8 requests of 4-23 tokens
drawn from ``default_rng(seed)``, 16 new tokens, 4 slots, ``max_seq`` 128).
Greedy tokens must equal the reference's, except where the two parts at a
near-tie: the top-2 logit gap at that token within 2·2e-3 (twice the
prefill-vs-forward tolerance of ``tests/test_models.py``); such a request
is compared up to there and the near-ties counted.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import init_params
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import init_params as init_lm
from repro_torch.serving import ServeEngine

TOL = 2e-3


def _launcher_prompts(vocab: int, seed: int = 0, n: int = 8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 24))) for _ in range(n)]


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=16)
    return eng.run_until_drained()


@pytest.fixture(scope="module")
def zamba():
    cfg = reduced(get_config("zamba2-7b"))
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = tconfigs.reduced(tconfigs.get_config("zamba2-7b"))
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, model


def test_serve_engine_gives_the_reference_tokens(zamba):
    cfg, params, tcfg, model = zamba
    prompts = _launcher_prompts(cfg.vocab)
    ref = _serve(JaxServeEngine(cfg, params, max_slots=4, max_seq=128), prompts)
    eng = ServeEngine(tcfg, model, max_slots=4, max_seq=128, device="cpu")
    mine = _serve(eng, prompts)
    assert [r.rid for r in mine] == [r.rid for r in ref]
    compared, near_ties = _compare_tokens(mine, ref)
    assert compared >= 100 and near_ties <= 1, (compared, near_ties)
    assert [w["size"] for w in eng.wave_stats] == [4, 4]
    assert all(w["decode_steps"] == 15 for w in eng.wave_stats)


def _compare_tokens(mine, ref) -> tuple[int, int]:
    """Tokens equal up to a near-tie per request: ``(compared, near_ties)``."""
    compared = near_ties = 0
    for rm, rr in zip(mine, ref):
        assert rm.done and len(rm.top2_gap) == len(rm.out_tokens)
        for j, (a, b) in enumerate(zip(rm.out_tokens, rr.out_tokens)):
            if a != b:
                assert rm.top2_gap[j] <= 2 * TOL, (rm.rid, j, rm.top2_gap[j])
                near_ties += 1
                break
            compared += 1
        else:
            assert len(rm.out_tokens) == len(rr.out_tokens) == 16
    return compared, near_ties


def test_serve_engine_on_ring_caches_gives_the_reference_tokens():
    """Reduced gemma3-12b (``LLLLLG``, window 16): the launcher's traffic,
    left-padded waves of 4-23-token prompts, decoded 16 tokens on, up to
    position 38, so every ``L`` layer's ring of 16 slots wraps more than
    once; the tokens equal the reference engine's."""
    cfg = reduced(get_config("gemma3-12b"))
    params = init_params(cfg, jax.random.PRNGKey(0))
    tcfg = tconfigs.reduced(tconfigs.get_config("gemma3-12b"))
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prompts = _launcher_prompts(cfg.vocab)
    ref = _serve(JaxServeEngine(cfg, params, max_slots=4, max_seq=128), prompts)
    eng = ServeEngine(tcfg, model, max_slots=4, max_seq=128, device="cpu")
    mine = _serve(eng, prompts)
    assert [r.rid for r in mine] == [r.rid for r in ref]
    compared, near_ties = _compare_tokens(mine, ref)
    assert compared >= 100 and near_ties <= 1, (compared, near_ties)
    assert max(w["prompt_len"] + w["decode_steps"] for w in eng.wave_stats) > 2 * cfg.attn_window


def test_serve_engine_plain_impl_gives_the_same_tokens_on_cpu(zamba):
    _, _, tcfg, model = zamba
    prompts = _launcher_prompts(tcfg.vocab, seed=1, n=3)
    a = _serve(ServeEngine(tcfg, model, max_slots=2, max_seq=64, device="cpu"), prompts)
    b = _serve(ServeEngine(tcfg, model, max_slots=2, max_seq=64, impl="plain", device="cpu"),
               prompts)
    assert [r.out_tokens for r in a] == [r.out_tokens for r in b]


def test_serve_engine_checks_its_arguments_and_defers_later_pools(zamba):
    """The arguments of the serving slice are carried and every pool runs:
    exemplars (``select_exemplars``, the drained and continuous waves),
    aggregates and the continuous LM loop, all on the CPU when asked."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.data.block_store import Table, build_block_store
    from repro_torch.obs import TraceRecorder
    from repro_torch.serving import AdmissionPolicy

    _, _, tcfg, model = zamba
    with pytest.raises(ValueError, match="impl"):
        ServeEngine(tcfg, model, device="cpu", impl="xla")
    with pytest.raises(ValueError, match="unsupported device"):
        ServeEngine(tcfg, model, device="meta")
    rec = TraceRecorder()
    pol = AdmissionPolicy(slo_s=1.0, max_wave=2)
    eng = ServeEngine(tcfg, model, max_slots=2, max_seq=48, device="cpu", exemplar_device=True,
                      exemplar_policy=pol, aggregate_policy=pol, recalibrate_every=3, obs=rec)
    assert (eng.exemplar_device, eng.recalibrate_every, eng.obs) == (True, 3, rec)
    assert eng.exemplar_admission.policy is pol and eng.exemplar_admission.obs is rec
    rng = np.random.default_rng(0)
    t = Table(rng.integers(0, 2, (4096, 2)).astype(np.int32),
              rng.normal(size=(4096, 1)).astype(np.float32), np.asarray([2, 2]))
    anyk = NeedleTailEngine(build_block_store(t, 64, device="cpu"), device="cpu")
    assert ServeEngine.select_exemplars(anyk, [(0, 1)], 20).num_records >= 20
    ex = [eng.submit_exemplar_request([(0, 1)], 30), eng.submit_exemplar_request([(1, 1)], 40)]
    assert eng.pump_exemplar_requests(anyk) == ex  # a full wave
    ex2 = eng.submit_exemplar_request([(0, 1), (1, 1)], 50)
    assert eng.drain_exemplar_requests(anyk) == [ex2]
    lm = eng.submit(np.arange(5) + 3, max_new_tokens=3)
    ex3 = eng.submit_exemplar_request([(0, 0)], 25)
    agg = eng.submit_aggregate_request([(0, 1)], 0, 200, error_slo=0.5)
    assert eng.lm_tick() == []  # the prefill tick
    out = eng.run_continuous(anyk)
    assert out == {"lm": [lm], "exemplar": [ex3], "aggregate": [agg]}
    assert len(lm.out_tokens) == 3 and eng.lm_tick_stats[0]["joiners"] == 1
    assert all(r.done for r in (*ex, ex2, ex3, lm, agg))
    assert eng.step(anyk) == {"lm": [], "exemplar": [], "aggregate": []}
    assert {e["name"] for e in rec.to_events()} >= {"serve.lm_tick", "serve.exemplar_tick",
                                                     "serve.aggregate_tick"}


def test_step_factories_run_prefill_and_decode(zamba):
    _, _, tcfg, model = zamba
    toks = torch.from_numpy(np.arange(12, dtype=np.int64)[None] + 3)
    with torch.inference_mode():
        last, cache = make_prefill_step(tcfg, max_seq=13)(model, {"tokens": toks})
        lg, _ = make_decode_step(tcfg)(model, cache, torch.tensor([5]), 12)
        full = model(torch.cat([toks, torch.tensor([[5]])], dim=1))
    np.testing.assert_allclose(last.numpy(), full[:, 11].numpy(), atol=TOL)
    np.testing.assert_allclose(lg.numpy(), full[:, 12].numpy(), atol=TOL)


def test_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    n = tserve.main(["--arch", "zamba2-7b", "--requests", "3", "--max-new", "4", "--slots", "2",
                     "--max-seq", "48", "--device", "cpu"])
    assert n == 3
    assert "on cpu: 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gemma3-12b", "h2o-danube-3-4b"])
def test_serve_launcher_runs_sliding_window_archs_on_the_cpu(arch, capsys):
    """The ``L`` family through the launcher: 24 new tokens carry the
    decode past the reduced window of 16."""
    n = tserve.main(["--arch", arch, "--requests", "2", "--max-new", "24", "--slots", "2",
                     "--max-seq", "64", "--device", "cpu"])
    assert n == 2
    assert "on cpu: 2 requests, 48 tokens" in capsys.readouterr().out


def test_serve_launcher_reduced_flag_can_be_turned_off(monkeypatch):
    built = []

    def spy(cfg, *args, **kwargs):
        built.append(cfg)
        raise SystemExit(0)

    monkeypatch.setattr(tserve, "init_params", spy)
    for flag, want in (([], "zamba2-7b-reduced"), (["--no-reduced"], "zamba2-7b")):
        with pytest.raises(SystemExit):
            tserve.main(["--arch", "zamba2-7b", "--device", "cpu", *flag])
        assert built[-1].name == want
    assert built[-1].d_model == 3584


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_lm_phases_pass_on_a_reduced_cpu_model(monkeypatch):
    """chip_smoke.py's lm_forward, lm_serve and LM kernel-row functions on
    reduced zamba2 on the CPU (the kernels' plain versions; the launch
    counts a card run would read are handed in, CUDA-event timing replaced
    by a call), and its checks failing where they should."""
    cs = _chip_smoke()
    tcfg = tconfigs.reduced(tconfigs.get_config(cs.LM_ARCH))
    model = init_lm(tcfg, 0, device="cpu")
    want = cs.lm_layer_counts(tcfg)
    assert want == {"flash_attention": 1, "ssd_scan": 5}
    waves = []

    def run(name, fn):
        out = fn()
        n = len(out[0].wave_stats) if name == "lm_serve" else 1
        waves.append(name)
        return out, 0.5, {**dict.fromkeys(cs.KERNELS, 0), **{k: v * n for k, v in want.items()}}

    fwd = cs.lm_forward_check(model, 40, 0, run)
    assert fwd["max_abs_err"] < 1e-4 and fwd["launches"]["ssd_scan"] == 5
    long = {**cs.SERVE_TRAFFIC["long"], "plen": (100, 140), "max_seq": 160}
    for traffic in (cs.SERVE_TRAFFIC["launcher"], long):
        res = cs.lm_serve_check(model, traffic, 0, run)
        assert res["streams"]["tokens_equal"] == res["streams"]["tokens"] > 0
        assert res["prefill"]["logits_max_abs_err"] < 1e-4
        assert set(res["prefill"]["cache_max_abs_err"]) == {"conv", "ssd", "k", "v"}
    assert waves == ["lm_forward", "lm_serve", "lm_serve"]
    monkeypatch.setattr(cs, "time_ms", lambda fn, flush=None: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "DANUBE_ATTN", (1, 4, 2, 80, 24, 32))
    monkeypatch.setattr(cs, "MAMBA2_130M_SSD", (1, 2, 256, 64, 128))
    monkeypatch.setattr(cs, "SSD_64_CHUNKS", (1, 4, 1024, 16, 16))  # 8 chunks on the CPU
    trace = {f"phase{i}": {"ms": 0.1, "per_call": 1.0} for i in (1, 2, 3)}  # as a card's
    monkeypatch.setattr(cs, "device_ms", lambda fn, runs=10: (fn(), trace)[1])
    # on the CPU the bf16 wrapper is attention_ref's bf16 arithmetic, not the
    # kernel's f32 sums: held at the reference's bf16 tolerance
    monkeypatch.setattr(cs, "FA_BF16_ATOL", 3e-2)
    monkeypatch.setattr(cs, "FA_BF16_RTOL", 3e-2)
    launches = {ph: {k: 1 for k in cs.KERNELS} for ph in cs.PHASE_KERNELS}
    rows = cs.lm_kernel_rows(tcfg, launches, 300, 0, torch.device("cpu"))  # 3 SSD chunks
    assert [r["name"] for r in rows] == list(cs.LM_KERNELS)
    assert rows[1]["checks"]["slow_decay_carry_weight"] > cs.SSD_CARRY_MIN * cs.SSD_ATOL
    many = rows[1]["checks"]["chunks_64_slow_decay"]
    assert set(many) == {"y", "final_state", "carry_weight"}
    assert many["carry_weight"] > cs.SSD_CARRY_MIN * cs.SSD_ATOL
    assert {"final_state", "y_with_state", "slow_decay_final_state"} <= set(rows[1]["checks"])
    # #9 runs its products in 3xTF32 too: both bounds; its CUDA kernels a
    # call as the profiler counted them; the TF32 control needs the card
    assert "bound_fma_ms" in rows[1] and rows[1]["cuda_kernels_per_call"] == 3.0
    assert rows[1]["phase_ms"] == {f"phase{i}": 0.1 for i in (1, 2, 3)}
    assert "state_ms" in rows[1]
    assert rows[1]["checks"]["rel_err"] == 0.0 and rows[1]["checks"]["tf32_control"] is None
    with pytest.raises(AssertionError, match="cannot see a wrong carry"):
        cs.lm_kernel_rows(tcfg, launches, 40, 0, torch.device("cpu"))  # one chunk: no carry
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(r) for r in rows)
    assert rows[0]["library_ms"] == 0.0 and rows[1]["library_ms"] is None
    # the checks fail where they should
    with pytest.raises(AssertionError, match="non-finite"):
        cs.check_close(torch.tensor([float("nan")]), torch.tensor([0.0]), 1e-3, 1e-3, "x")
    with pytest.raises(AssertionError, match="beyond"):
        cs.check_close(torch.tensor([1.0]), torch.tensor([0.9]), 1e-3, 1e-3, "x", "tensor")
    with pytest.raises(AssertionError, match="expected"):
        cs.check_launches({"flash_attention": 0, "ssd_scan": 5}, want, "lm")
    a = [type("R", (), {"rid": 0, "out_tokens": [1, 2], "top2_gap": [1.0, 1.0]})()]
    b = [type("R", (), {"rid": 0, "out_tokens": [1, 3], "top2_gap": [1.0, 1.0]})()]
    with pytest.raises(AssertionError, match="top-2 gap"):
        cs.compare_streams(a, b, 2e-3)
    b[0].top2_gap = [1.0, 1e-3]  # a near-tie: counted, not failed
    assert cs.compare_streams(a, b, 2e-3) == {"tokens_equal": 1, "near_ties": 1, "tokens": 2}


def test_chip_smoke_swa_phases_pass_on_a_narrow_cpu_model(monkeypatch):
    """chip_smoke.py's lm_forward_swa and lm_serve_swa phases and #8's
    sliding-window rows on a narrow gemma3 at its own head dim of 240 (one
    LLLLLG cycle, window 16) on the CPU: 6 attention launches per forward,
    long prompts past the window (rings arranged by prefill and compared
    slot for slot), the head-dim sweep, and the windowed and global shapes
    with their SDPA yardstick computing the same function."""
    import dataclasses

    cs = _chip_smoke()
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(cs.SWA_ARCH)),
                               d_model=480, num_heads=2, num_kv_heads=1)
    assert tcfg.head_dim == 240 and tcfg.attn_window == 16
    model = init_lm(tcfg, 0, device="cpu")
    want = cs.lm_layer_counts(tcfg)
    assert want == {"flash_attention": 6, "ssd_scan": 0}
    phases = []

    def run(name, fn):
        out = fn()
        n = len(out[0].wave_stats) if name == "lm_serve_swa" else 1
        phases.append(name)
        return out, 0.5, {**dict.fromkeys(cs.KERNELS, 0), **{k: v * n for k, v in want.items()}}

    fwd = cs.lm_forward_check(model, 40, 0, run, "lm_forward_swa")
    assert fwd["max_abs_err"] < 1e-4 and fwd["launches"]["flash_attention"] == 6
    long = {**cs.SERVE_TRAFFIC["long"], "plen": (20, 40), "max_seq": 60}
    res = cs.lm_serve_check(model, long, 0, run, "lm_serve_swa")
    assert res["streams"]["tokens_equal"] == res["streams"]["tokens"] > 0
    assert res["prefill"]["prompt_len"] > tcfg.attn_window
    assert set(res["prefill"]["cache_max_abs_err"]) == {"k", "v"}
    assert phases == ["lm_forward_swa", "lm_serve_swa"]
    with pytest.raises(AssertionError, match="lm_serve_swa: launches"):
        cs.check_launches({"flash_attention": 5, "ssd_scan": 0}, want, "lm_serve_swa")
    monkeypatch.setattr(cs, "time_ms", lambda fn, flush=None: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "DANUBE_ATTN", (1, 4, 2, 80, 24, 32))
    monkeypatch.setattr(cs, "SSD_64_CHUNKS", (1, 4, 1024, 16, 16))  # #9's rows: CPU sizes
    monkeypatch.setattr(cs, "device_ms", lambda fn, runs=10: (fn(), {})[1])
    monkeypatch.setattr(cs, "FA_BF16_ATOL", 3e-2)  # attention_ref's bf16 arithmetic on the CPU
    monkeypatch.setattr(cs, "FA_BF16_RTOL", 3e-2)
    launches = {ph: {k: 1 for k in cs.KERNELS} for ph in cs.PHASE_KERNELS}
    launches["lm_forward_swa"]["flash_attention"] = 48
    zcfg = tconfigs.reduced(tconfigs.get_config(cs.LM_ARCH))
    fa, ssd = cs.lm_kernel_rows(zcfg, launches, 130, 0, torch.device("cpu"), swa=(tcfg, 70))
    # no device kernel traced: the count is unknown, not assumed
    assert ssd["cuda_kernels_per_call"] is None and ssd["phase_ms"] == {}
    assert sorted(fa["checks"]["d_sweep"]) == sorted(cs.FA_D_SWEEP)
    rows = fa[tcfg.name]
    assert rows["launches_per_forward"] == 48
    assert rows["shape"] == {"B": 4, "Hq": 2, "Hkv": 1, "S": 70, "T": 70, "D": 240}
    # 16·17/2 pairs for the first 16 queries, then 16 for each of the other 54
    assert rows["window"]["visible_pairs"] == 136 + 54 * 16
    assert rows["global"]["visible_pairs"] == 70 * 71 // 2
    for name in ("window", "global"):
        assert rows[name]["library_max_abs_err"] < 1e-5
        pairs = rows[name]["visible_pairs"]
        nbytes, ops = (2 * 2 + 2 * 1) * 4 * 70 * 240 * 4, 4.0 * 4 * 2 * 240 * pairs
        assert (rows[name]["bound_ms"], rows[name]["bound_by"]) == cs.bound_tf32x3_ms(nbytes, ops)
        assert rows[name]["bound_fma_ms"] == cs.bound_ms(nbytes, ops)[0]
    assert cs.visible_pairs(3, 5, None) == 3 + 4 + 5 and cs.visible_pairs(3, 5, 2) == 6


def test_chip_smoke_bounds_flash_attention_on_the_3xtf32_datapath():
    """#8 does its f32 products as three TF32 products on the tensor cores:
    at zamba2-7b's long wave (B 4, 32 heads, S = T = 1,895, D 112, causal)
    its bound is 3·ops at 494.7 TFLOP/s, with the f32 FMA bound of the
    earlier FMA kernel (1.5376 ms) kept beside it; a kernel_row marked
    tf32x3 carries both."""
    cs = _chip_smoke()
    nbytes = 4 * 4 * 32 * 1895 * 112 * 4
    ops = 4.0 * 4 * 32 * 112 * cs.visible_pairs(1895, 1895, None)
    fma, by = cs.bound_ms(nbytes, ops)
    assert by == "operations" and abs(fma - 1.5375552573134328) < 1e-9
    ms, by = cs.bound_tf32x3_ms(nbytes, ops)
    assert by == "operations (3xTF32)" and ms == pytest.approx(fma * 3 * 67 / 494.7)
    assert cs.bound_tf32x3_ms(1e12, 1.0)[1] == "bytes"
    launches = {ph: {k: 1 for k in cs.KERNELS} for ph in cs.PHASE_KERNELS}
    row = cs.kernel_row("flash_attention", launches, 0.0, 2.0, 3.0, 2.5, nbytes, ops,
                        tf32x3=True)
    assert (row["bound_ms"], row["bound_by"], row["bound_fma_ms"]) == (ms, by, fma)
    assert "bound_fma_ms" not in cs.kernel_row("ssd_scan", launches, 0.0, 2.0, 3.0, None,
                                               nbytes, ops)


def test_chip_smoke_ptxas_report_names_the_kernel_instances():
    """The build log's ptxas lines become one line per kernel, each named
    with its template arguments: #8's type, output blocks and exactness;
    the others by name alone."""
    cs = _chip_smoke()
    log = """== flash_attention.cu
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_c28d732722flash_attention_kernelIfLi14ELb1EEEvPKT_S3_S3_PS1_lllliiilfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 244 registers, used 1 barriers
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_c28d732722flash_attention_kernelI13__nv_bfloat16Li4ELb0EEEvPKT_S4_S4_PS2_lllliiilfi
    24 bytes stack frame, 36 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
== window_scan.cu
ptxas info    : Function properties for _ZN12_GLOBAL__N_122prefix_sum_smem_kernelEPKfiPfi
    128 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
"""
    assert cs.ptxas_report(log) == [
        "== flash_attention.cu",
        "flash_attention_kernel<float, 14, true>: 244 registers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "flash_attention_kernel<__nv_bfloat16, 4, false>: 80 registers; "
        "24 bytes stack frame, 36 bytes spill stores, 32 bytes spill loads",
        "== window_scan.cu",
        "prefix_sum_smem_kernel: 32 registers; "
        "128 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ]


def test_chip_smoke_ptxas_report_names_the_ssd_instances():
    """#9's three kernels by the same demangling: phase 1 by its 16-row
    tiles a warp, phase 3 by its padded d_state, phase 2 by name; and the
    literals it may meet (negative, unsigned, a named type)."""
    cs = _chip_smoke()
    log = """== ssd_chunk.cu
ptxas info    : Function properties for _ZN45_GLOBAL__N__08e282b6_12_ssd_chunk_cu_08e282b617ssd_output_kernelILi64EEEvPKfS2_S2_S2_S2_Pflllliillll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_116ssd_state_kernelILi2EEEvPKfS2_S2_PfS3_llliill
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 121 registers, used 1 barriers
ptxas info    : Function properties for _ZN45_GLOBAL__N__08e282b6_12_ssd_chunk_cu_08e282b615ssd_pass_kernelEPfPKfS0_lll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers
"""
    spill = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    assert cs.ptxas_report(log) == [
        "== ssd_chunk.cu",
        f"ssd_output_kernel<64>: 168 registers; {spill}",
        f"ssd_state_kernel<2>: 121 registers; {spill}",
        f"ssd_pass_kernel: 80 registers; {spill}",
    ]
    assert cs.demangle("_Z1kILin3ELj7E6__halfhEvv") == "k<-3, 7, __half, unsigned char>"


def test_chip_smoke_traces_sdpa_kernels_in_a_fresh_process(monkeypatch):
    """``--profile`` names the kernels SDPA launches in f32 from a new
    process (the script's own profiler state is spent by then): the child's
    code compiles, takes the requested shape, and its last line is parsed."""
    cs = _chip_smoke()
    seen = {}

    def fake_run(cmd, **kw):
        seen["code"] = cmd[2]
        compile(cmd[2], "sdpa_kernels", "exec")
        return type("Done", (), {"stdout": 'a warning\n["fmha_cutlassF_f32"]\n'})

    monkeypatch.setattr(cs.subprocess, "run", fake_run)
    assert cs.sdpa_kernels(4, 32, 1895, 112) == ["fmha_cutlassF_f32"]
    assert "torch.randn((4, 32, 1895, 112), device='cuda')" in seen["code"]
