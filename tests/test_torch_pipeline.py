"""The port's training data pipeline and checkpoint manager, on the CPU.

``make_token_corpus`` draws the reference's table and tokens bit for bit;
``FilteredBatchStream`` (the filter's combine with the consumed blocks
excluded, THRESHOLD, the block read and the mask on the store's device;
the consumed mask, round, rng counter and buffer on the host) gives the
reference's ``record_ids`` batch for batch, across epoch resets, for a pair
filter, a single predicate and the empty filter, and its state equals the
reference's after every batch.  The checkpoint tests mirror
``tests/test_substrate.py:23-110`` on the port, then add what the port's
state adds: a ``TrainState`` with bf16 moments round trip, the model filled
in place, and ``restore(shardings=)`` without a mesh (``None`` leaves).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as RP
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.checkpoint.manager import flatten_state
from repro_torch.configs import get_config, reduced
from repro_torch.data import pipeline as TP
from repro_torch.launch.steps import TrainState, make_train_state
from repro_torch.models import init_params


def _corpora(num_seqs, seq_len, seed):
    rs, rt = RP.make_token_corpus(num_seqs=num_seqs, seq_len=seq_len, seed=seed)
    ts, tt = TP.make_token_corpus(num_seqs=num_seqs, seq_len=seq_len, seed=seed, device="cpu")
    return rs, rt, ts, tt


@pytest.mark.parametrize("num_seqs,seq_len,vocab,seed", [(512, 32, 512, 1), (300, 17, 50280, 4)])
def test_make_token_corpus_equals_reference(num_seqs, seq_len, vocab, seed):
    rs, rt = RP.make_token_corpus(num_seqs=num_seqs, seq_len=seq_len, vocab=vocab, seed=seed)
    ts, tt = TP.make_token_corpus(num_seqs=num_seqs, seq_len=seq_len, vocab=vocab, seed=seed,
                                  device="cpu")
    assert tt.dtype == torch.int32 and tt.device.type == "cpu"
    np.testing.assert_array_equal(tt.numpy(), rt)
    for name in ("dims", "measures", "valid_rows"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(rs, name)))
    np.testing.assert_array_equal(ts.index.densities.numpy(), np.asarray(rs.index.densities))
    assert (ts.num_blocks, ts.records_per_block) == (rs.num_blocks, rs.records_per_block)


def test_make_token_corpus_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.make_token_corpus(num_seqs=64, seq_len=8)


def test_parse_filter_matches_reference():
    for expr in ("", "domain=code", "domain=code,quality=hi", " lang = zh , len_bucket=long"):
        assert TP.parse_filter(expr) == RP.parse_filter(expr)


@pytest.mark.parametrize("expr,num_seqs,batch,draws", [
    ("domain=code,quality=hi", 512, 8, 40),  # a pair filter, several epochs
    ("lang=zh", 128, 4, 40),  # tests/test_substrate.py's epoch-reset case
    ("", 256, 8, 40),  # the empty filter: all ones
])
def test_stream_record_ids_equal_reference(expr, num_seqs, batch, draws):
    rs, rt, ts, tt = _corpora(num_seqs, 32, 1)
    a = RP.FilteredBatchStream(rs, rt, RP.parse_filter(expr), batch, seed=0)
    b = TP.FilteredBatchStream(ts, tt, TP.parse_filter(expr), batch, seed=0)
    for i in range(draws):
        x, y = next(a), next(b)
        assert y["record_ids"].dtype == np.int64
        np.testing.assert_array_equal(y["record_ids"], x["record_ids"], err_msg=f"batch {i}")
        assert y["tokens"].dtype == torch.int32 and y["labels"].dtype == torch.int32
        np.testing.assert_array_equal(y["tokens"].numpy(), x["tokens"])
        np.testing.assert_array_equal(y["labels"].numpy(), x["labels"])
        np.testing.assert_array_equal(b.state.consumed, a.state.consumed)
        assert (b.state.round, b.state.rng_counter, b._buffer) == \
            (a.state.round, a.state.rng_counter, a._buffer)
    assert b.state.round >= 1  # the draws crossed an epoch reset


def test_filtered_stream_only_matching_records():
    _, _, store, tokens = _corpora(512, 32, 1)
    stream = TP.FilteredBatchStream(store, tokens, TP.parse_filter("domain=code"), batch_size=8,
                                    seed=0)
    dims = store.dims.reshape(-1, store.dims.shape[-1]).numpy()
    for _ in range(4):
        b = next(stream)
        assert tuple(b["tokens"].shape) == (8, 31)
        assert np.all(dims[b["record_ids"], 0] == 1)  # domain == code


def test_filtered_stream_restart_exact():
    _, _, store, tokens = _corpora(512, 32, 1)
    preds = TP.parse_filter("quality=hi")
    s1 = TP.FilteredBatchStream(store, tokens, preds, batch_size=8, seed=0)
    [next(s1) for _ in range(3)]
    snapshot = TP.PipelineState.from_arrays(s1.state.to_arrays())
    buffered = list(s1._buffer)
    after = [next(s1)["record_ids"] for _ in range(6)]
    s2 = TP.FilteredBatchStream(store, tokens, preds, batch_size=8, seed=0, state=snapshot)
    s2._buffer = buffered
    for a in after:
        np.testing.assert_array_equal(next(s2)["record_ids"], a)


def test_stream_with_no_match_stops():
    _, _, store, tokens = _corpora(64, 8, 0)
    preds = TP.parse_filter("domain=code")
    stream = TP.FilteredBatchStream(store, tokens, preds, batch_size=8, seed=0)
    store.dims[..., 0] = 0  # no record is code any more; the index still says some are
    store.index.densities.zero_()
    with pytest.raises(StopIteration):
        next(stream)


def test_hedged_fetch_bounds_stragglers_as_reference():
    rs, _, ts, _ = _corpora(256, 16, 3)
    blocks = np.arange(8)

    def latency_of(seed):
        rng = np.random.default_rng(seed)

        def latency(ids, attempt):
            base = np.full(len(ids), 1.0)
            if attempt == 0:
                base[3] = 50.0  # one straggler
            return base + rng.random(len(ids)) * 0.1
        return latency

    out, t = TP.hedged_fetch(ts, blocks, latency_of(0), hedge_quantile=0.8)
    _, t_ref = RP.hedged_fetch(rs, blocks, latency_of(0), hedge_quantile=0.8)
    assert out is blocks and t < 5.0  # straggler replaced by its hedge
    assert t == t_ref
    assert TP.hedged_fetch(ts, np.zeros(0, np.int64), lambda ids, a: np.ones(len(ids)))[1] == 0.0


# ---- checkpoints: tests/test_substrate.py:23-57 on the port


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)}}
    for step in (1, 2, 3):
        mgr.save(step, state, extra={"tag": step})
    assert latest_step(tmp_path) == 3
    kept = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert kept == ["step_2", "step_3"]  # keep-k pruning
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.int32)}}
    restored, step = mgr.restore(like)
    assert step == 3 and mgr.extra(3) == {"tag": 3}
    assert restored["b"]["c"].dtype == torch.int32
    torch.testing.assert_close(restored["a"], state["a"], rtol=0, atol=0)
    torch.testing.assert_close(restored["b"]["c"], state["b"]["c"], rtol=0, atol=0)
    meta = json.loads((tmp_path / "step_3" / "meta.json").read_text())
    assert set(meta["manifest"]) == {"a", "b.c"}


def test_checkpoint_partial_save_is_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, {"x": torch.zeros(3)})
    bad = tmp_path / "step_9"  # a crash mid-save: uncommitted dir
    bad.mkdir()
    (bad / "meta.json").write_text("{}")
    tmp = tmp_path / "step_7.tmp"
    tmp.mkdir()
    assert latest_step(tmp_path) == 5  # sentinel missing -> ignored
    CheckpointManager(tmp_path)  # re-init garbage-collects both
    assert not bad.exists() and not tmp.exists()


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"x": torch.zeros((3, 3))})
    with pytest.raises(KeyError, match="missing leaf y"):
        mgr.restore({"y": torch.zeros((2, 2))})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"x": torch.zeros(1)})


def test_restore_with_shardings_raises_until_the_multi_gpu_slice(tmp_path):
    """The multi-GPU slice has landed: ``restore(shardings=)`` no longer
    raises ``NotImplementedError``.  A ``None`` sharding restores the leaf
    unplaced; a leaf that is not a ``NamedSharding`` is refused.  (Placing
    on a mesh is tested with a world in ``test_torch_distributed.py``.)"""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.arange(2.0)})
    out, step = mgr.restore({"x": torch.zeros(2)}, shardings={"x": None})
    assert step == 1 and torch.equal(out["x"], torch.arange(2.0))
    with pytest.raises(TypeError, match="NamedSharding"):
        mgr.restore({"x": torch.zeros(2)}, shardings={"x": ("data",)})


def test_train_state_round_trip_bf16_moments_fills_the_model(tmp_path):
    cfg = reduced(get_config("mamba2-130m"))
    st = make_train_state(init_params(cfg, 0, device="cpu"), state_dtype=torch.bfloat16)
    names = [n for n, _ in st.model.named_parameters()]
    for n in names:  # distinct moments and a nonzero step
        st.opt.m[n].normal_()
        st.opt.v[n].uniform_()
    st = TrainState(st.model, st.opt._replace(step=st.opt.step + 7), st.step + 7)
    leaves = flatten_state(st)
    assert set(leaves) == ({f"model.{n}" for n in names} | {f"opt.m.{n}" for n in names}
                           | {f"opt.v.{n}" for n in names} | {"opt.step", "step"})
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, st)
    fresh = make_train_state(init_params(cfg, 1, device="cpu"), state_dtype=torch.bfloat16)
    out, step = mgr.restore(fresh)
    assert step == 7 and out.model is fresh.model and int(out.step) == 7
    assert out.step.dtype == torch.int32 and int(out.opt.step) == 7
    for n, p in st.model.named_parameters():
        torch.testing.assert_close(dict(fresh.model.named_parameters())[n], p, rtol=0, atol=0)
        assert out.opt.m[n].dtype == torch.bfloat16
        torch.testing.assert_close(out.opt.m[n], st.opt.m[n], rtol=0, atol=0)
        torch.testing.assert_close(out.opt.v[n], st.opt.v[n], rtol=0, atol=0)
