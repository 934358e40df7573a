"""The TPC-H LINEITEM configuration on the CPU at tiny sizes: its layout
against the plain reference of the specification's rules, whole runs of its
cell through the harness, a fault in the three-predicate masks, and a slice
no row meets."""
import json
import time

import numpy as np
import pytest
import torch

from bench import harness, traffic
from bench.check import plan_verdicts
from bench.reference import anyk
from bench.reference import tpch_lineitem as ref
from bench.tests.conftest import ROOT

WORKLOAD = "tpch-lineitem-sample-closed"
# 48 blocks of 256 rows, the last one padded
TINY = {"num_records": 256 * 48 - 100, "records_per_block": 256}


def _cfg() -> dict:
    return dict(json.loads((ROOT / "bench" / "configs" / "tpch-lineitem-sf30.json").read_text()),
                **TINY)


def _layout():
    return harness.load_module("layouts", "tpch_lineitem")


def _columns(seed: int, n: int = 20_000) -> dict:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return _layout().columns(n, gen, "cpu", scale_factor=30)


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_the_layout_keeps_every_rule(seed):
    cols = _columns(seed)
    comment = cols.pop("comment")
    assert all(c.numel() == 20_000 and c.dtype == torch.int32 for c in cols.values())
    assert comment.shape == (20_000, 44) and comment.dtype == torch.uint8
    cols["comment"] = comment
    assert ref.violations(cols, 30) == dict.fromkeys(ref.violations(cols, 30), 0)
    dims, meas = _layout().encode(cols)
    want_dims, want_meas = ref.stored(cols)
    cfg = _cfg()
    assert dims.dtype == torch.int32 and meas.dtype == torch.float32
    # every column of LINEITEM's row: 8 dims, 2 prices, 7 int32 words, a 44-byte comment
    assert dims.shape[1] == len(cfg["cards"]) and meas.shape[1] == len(cfg["measures"]) == 20
    np.testing.assert_array_equal(dims.numpy(), want_dims)
    np.testing.assert_array_equal(meas.numpy().view(np.int32), want_meas.view(np.int32))
    # each order's lines are numbered 1, 2, ... and keyed by the first 8 of every 32 keys
    key, line = meas[:, 2].view(torch.int32), meas[:, 5].view(torch.int32)
    assert set((key % 32).unique().tolist()) <= set(range(1, 9))
    assert bool((line[1:] == torch.where(key[1:] == key[:-1], line[:-1] + 1, 1)).all())
    assert all(int(dims[:, a].max()) < card for a, card in enumerate(cfg["cards"]))
    # the dependent pairs: R and O never meet; N and F do, on a thin band of dates
    flag, status = dims[:, 0], dims[:, 1]
    assert int(((flag == ref.R) & (status == 1)).sum()) == 0
    assert 0 < int(((flag == ref.N) & (status == 0)).sum()) < 0.02 * flag.numel()


def test_a_broken_rule_is_counted():
    cols = _columns(3)
    cols["returnflag"] = torch.full_like(cols["returnflag"], ref.N)
    cols["quantity"] = cols["quantity"].clone()
    cols["quantity"][5] = 51
    cols["suppkey"] = cols["suppkey"].clone()
    cols["suppkey"][6] = 0
    cols["comment"] = cols["comment"].clone()
    cols["comment"][7, 2] = ord(" ")  # a space inside the text
    cols["comment"][8, 43] = ord("a")  # 44 symbols, one past the longest
    bad = ref.violations(cols, 30)
    assert bad["returnflag"] > 0 and bad["quantity_range"] == 1
    assert bad["suppkey"] == 1 and bad["comment"] == 2
    assert sum(bad.values()) == bad["returnflag"] + 4


def test_the_same_seed_gives_the_same_table():
    gen = [torch.Generator().manual_seed(2**31 + 5) for _ in range(3)]
    a, b = (_layout().generate(5_000, g, "cpu", 30) for g in gen[:2])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
    other = _layout().generate(5_000, torch.Generator().manual_seed(6), "cpu", 30)
    assert not torch.equal(a[0], other[0])


def run(bench, trace=False, seed=2**31 + 7, grace_s=60.0):
    return harness.run_cell(bench, WORKLOAD, seed, 0.5, trace, "cpu", time.monotonic(), TINY,
                            grace_s=grace_s)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_tiny_cell_is_correct(bench, trace):
    res = run(bench, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert all(c["value"] == 0 for c in res["check"].values())
    if trace:
        for name in ("select_ms.sample", "gather_mb_per_round.sample", "record_ms.sample",
                     "rows_read_per_record.sample", "d2h_copies_per_round.sample"):
            assert np.isfinite(res["metrics"][name]["value"]) and res["metrics"][name]["value"] > 0
    else:
        assert set(res["metrics"]) == {"setup_s", "queries_per_s"}


def test_a_third_predicate_left_out_of_the_masks_is_caught(bench, monkeypatch):
    import repro_torch.core.multi_query as mq

    orig = mq._predicate_table

    def two_of_three(states):
        attrs, vals, is_or = orig(states)
        if attrs.shape[1] > 2:
            attrs = attrs.copy()
            attrs[:, 2] = -1  # the third pair counts as padding
        return attrs, vals, is_or

    monkeypatch.setattr(mq, "_predicate_table", two_of_three)
    res = run(bench)
    assert not res["correct"] and res["check"]["records_off"]["value"] > 0


def test_an_empty_slice_is_answered_once_with_no_records():
    """R and O never meet, yet the index, a product of each attribute's
    densities, gives the pair density in every block: the query plans a block
    a round until ``max_refills``, finds nothing, and is answered once, with
    the blocks the reference's refill rounds read."""
    from repro_torch.serving.engine import ServeEngine

    cfg = _cfg()
    setup = harness.build(cfg, 13, torch.device("cpu"))
    preds = ((0, ref.R), (1, 1))
    assert harness.match_counter(setup.dims)(preds) == 0
    serve = ServeEngine(None, None, max_slots=4, exemplar_device=True, device="cpu")
    req = serve.submit_exemplar_request(list(preds), 1, "and")
    done = []
    for _ in range(64):
        done += serve.step(setup.engine, drain=True)["exemplar"]
    assert done == [req] and req.done
    res = req.result
    assert res.num_records == 0 and res.record_block.size == 0
    rpb, rounds = int(cfg["records_per_block"]), int(cfg["max_refills"])
    assert res.plan_rounds == rounds and res.blocks_fetched.size == rounds
    dims = setup.dims
    dens = anyk.density_index(dims, cfg["cards"], rpb)
    comb = anyk.combine(dens, anyk.row_ids(cfg["cards"], preds), "and")
    matches = anyk.block_matches(dims, preds, "and", rpb)
    blocks, n_rounds = anyk.run_exact(comb, 1, matches, rpb, rounds, anyk.COST_MODELS["hdd"])
    np.testing.assert_array_equal(res.blocks_fetched, blocks)
    verdicts = plan_verdicts(cfg, dims, dens, [traffic.Query(preds, 1, "and")],
                             [(res.blocks_fetched, res.plan_rounds)])
    assert verdicts["exact"] == 1 and n_rounds == rounds
