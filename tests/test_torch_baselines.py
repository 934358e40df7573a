"""The port's first-to-k baselines (§7.1) against the JAX package's, on the CPU.

Every case of ``tests/test_baselines.py`` runs on the port, and the same
numpy tables go through both packages: bitmap and lossy-bitmap words and
EWAH streams must equal the reference's uint64 words bit for bit (the port
holds them as int64), and every scan must return the reference's record
ids and blocks.
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core.density_map import build_density_maps as jax_build_density_maps
from repro_torch.core import baselines as tb
from repro_torch.core.density_map import build_density_maps

CARDS = (2, 3)


def _dims(seed, n=2000, cards=CARDS):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, c, n) for c in cards], axis=1).astype(np.int32)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _i64(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint64).view(np.int64))


def _word_lists():
    """Word arrays that exercise every EWAH branch: runs of 0 and of 1 words
    at either end and back to back, literals between them, the top bit."""
    rng = np.random.default_rng(9)
    ones, top = np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64(1 << 63)
    cases = [np.zeros(0, np.uint64), np.zeros(1, np.uint64), np.full(3, ones),
             np.asarray([5], np.uint64), np.asarray([top, 0, 0, ones, ones, 7, top, 0], np.uint64)]
    for seed in range(30):
        r = np.random.default_rng(seed)
        kind = r.integers(0, 3, int(r.integers(0, 200)))
        w = r.integers(0, 2**63, kind.size, dtype=np.uint64) | (
            r.integers(0, 2, kind.size).astype(np.uint64) << np.uint64(63))
        w[kind == 0], w[kind == 1] = 0, ones
        cases.append(w)
    runs = np.zeros(10_000, np.uint64)
    runs[5000:5004] = 12345
    cases.append(runs)
    cases.append(rng.integers(0, 2**63, 64, dtype=np.uint64))
    return cases


@pytest.mark.parametrize("case", range(len(_word_lists())))
def test_ewah_stream_and_roundtrip_equal_reference(case):
    w = _word_lists()[case]
    ref = jb.ewah_compress(w)
    comp = tb.ewah_compress(_i64(w))
    assert comp.dtype == torch.int64
    np.testing.assert_array_equal(_u64(comp), ref)
    out = tb.ewah_decompress(comp, w.size)
    np.testing.assert_array_equal(_u64(out), w)
    np.testing.assert_array_equal(_u64(out), jb.ewah_decompress(ref, w.size))


def test_ewah_compresses_runs():
    w = np.zeros(10_000, np.uint64)
    w[5000:5004] = 12345
    assert tb.ewah_compress(_i64(w)).numel() < 20


def test_ewah_decompress_drops_what_falls_past_num_words():
    w = np.asarray([0, 0, 9, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF], np.uint64)
    comp = tb.ewah_compress(_i64(w))
    np.testing.assert_array_equal(_u64(tb.ewah_decompress(comp, 3)), w[:3])
    np.testing.assert_array_equal(_u64(tb.ewah_decompress(comp, 7)), np.concatenate(
        [w, np.zeros(2, np.uint64)]))


@pytest.mark.parametrize("seed,n", [(0, 2000), (1, 64), (2, 63), (3, 1), (4, 5000)])
def test_bitmap_and_ewah_indexes_equal_reference(seed, n):
    dims = _dims(seed, n)
    ref = jb.build_bitmap_index(dims, CARDS)
    mine = tb.build_bitmap_index(dims, CARDS, device="cpu")
    np.testing.assert_array_equal(_u64(mine.bits), ref.bits)
    assert mine.nbytes() == ref.nbytes() and mine.num_records == ref.num_records
    eref, emine = jb.build_ewah_index(ref), tb.build_ewah_index(mine)
    for a, b in zip(emine.streams, eref.streams):
        np.testing.assert_array_equal(_u64(a), b)
    assert emine.nbytes() == eref.nbytes()


def test_bitmap_build_in_chunks_equals_one_pass(monkeypatch):
    dims = _dims(5, 3000)
    whole = tb.build_bitmap_index(dims, CARDS, device="cpu")
    monkeypatch.setattr(tb, "_CHUNK", 640)
    np.testing.assert_array_equal(tb.build_bitmap_index(dims, CARDS, device="cpu").bits.numpy(),
                                  whole.bits.numpy())


@pytest.mark.parametrize("k", [1, 64, 150, 10_000])
def test_first_k_in_stretches_of_words_equals_reference(k, monkeypatch):
    """Scans that unpack three words (192 records) at a time stop at the
    k-th match and return the reference's records and blocks."""
    monkeypatch.setattr(tb, "_SCAN_WORDS", 3)
    dims = _dims(8, 1000)
    preds = [(0, 1), (1, 0)]
    mask = (dims[:, 0] == 1) & (dims[:, 1] == 0)
    idx = tb.build_bitmap_index(dims, CARDS, device="cpu")
    ref = jb.build_bitmap_index(dims, CARDS)
    for got, want in [*zip(tb.bitmap_scan(idx, preds, k, 64), jb.bitmap_scan(ref, preds, k, 64)),
                      *zip(tb.disk_scan(mask, k, 64), jb.disk_scan(mask, k, 64))]:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 17), (2, 200), (3, 10_000)])
@pytest.mark.parametrize("op", ["and", "or"])
def test_scans_equal_reference_and_truth(seed, k, op):
    dims = _dims(seed)
    preds = [(0, 1), (1, 2)]
    ref_idx = jb.build_bitmap_index(dims, CARDS)
    idx = tb.build_bitmap_index(dims, CARDS, device="cpu")
    truth_mask = (dims[:, 0] == 1) & (dims[:, 1] == 2) if op == "and" else \
        (dims[:, 0] == 1) | (dims[:, 1] == 2)
    truth = np.nonzero(truth_mask)[0][:k]
    recs, blocks = tb.bitmap_scan(idx, preds, k, records_per_block=64, op=op)
    np.testing.assert_array_equal(recs, truth)
    np.testing.assert_array_equal(blocks, np.unique(truth // 64))
    for got, want in zip((recs, blocks), jb.bitmap_scan(ref_idx, preds, k, 64, op)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tb.ewah_scan(tb.build_ewah_index(idx), preds, k, 64, op),
                         jb.ewah_scan(jb.build_ewah_index(ref_idx), preds, k, 64, op)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tb.disk_scan(torch.from_numpy(truth_mask), k, 64),
                         jb.disk_scan(truth_mask, k, 64)):
        np.testing.assert_array_equal(got, want)
    for s in range(3):
        for got, want in zip(
                tb.bitmap_random(idx, preds, k, 64, np.random.default_rng(s), op),
                jb.bitmap_random(ref_idx, preds, k, 64, np.random.default_rng(s), op)):
            np.testing.assert_array_equal(got, want)


def test_ewah_scan_equals_bitmap_scan():
    idx = tb.build_bitmap_index(_dims(3), CARDS, device="cpu")
    for a, b in zip(tb.bitmap_scan(idx, [(0, 0)], 50, 64),
                    tb.ewah_scan(tb.build_ewah_index(idx), [(0, 0)], 50, 64)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [4, 6])
def test_lossy_bitmap_equals_reference_and_is_a_superset_of_dense_blocks(seed):
    dims = _dims(seed)
    dm = build_density_maps(dims, CARDS, records_per_block=64, device="cpu")
    ref_dm = jax_build_density_maps(dims, CARDS, records_per_block=64)
    lossy = tb.build_lossy_bitmap(dm.densities, dm.vocab.attr_offsets)
    ref = jb.build_lossy_bitmap(np.asarray(ref_dm.densities), ref_dm.vocab.attr_offsets)
    np.testing.assert_array_equal(_u64(lossy.bits), ref.bits)
    assert lossy.nbytes() == ref.nbytes() and lossy.num_blocks == ref.num_blocks
    for op in ("and", "or"):
        cand = tb.lossy_bitmap_scan(lossy, [(0, 1), (1, 1)], op)
        np.testing.assert_array_equal(cand, jb.lossy_bitmap_scan(ref, [(0, 1), (1, 1)], op))
    truth = np.unique(np.nonzero((dims[:, 0] == 1) & (dims[:, 1] == 1))[0] // 64)
    assert set(truth) <= set(tb.lossy_bitmap_scan(lossy, [(0, 1), (1, 1)]).tolist())


def test_disk_scan_reads_prefix_blocks():
    dims = _dims(5)
    mask = (dims[:, 0] == 1) & (dims[:, 1] == 0)
    recs, blocks = tb.disk_scan(mask, 20, records_per_block=64)
    assert len(recs) == min(20, mask.sum())
    np.testing.assert_array_equal(blocks, np.arange(blocks[-1] + 1))
    assert recs[-1] // 64 == blocks[-1]
    recs, blocks = tb.disk_scan(np.zeros(130, bool), 5, 64)
    assert recs.size == 0 and blocks.tolist() == [0, 1, 2]


def test_index_memory_equals_reference():
    """Table 2's bytes: the density maps (with and without the sorted
    variants) against the bitmap, lossy-bitmap and EWAH indexes."""
    dims = _dims(7, 6000)
    dm = build_density_maps(dims, CARDS, records_per_block=64, device="cpu")
    ref_dm = jax_build_density_maps(dims, CARDS, records_per_block=64)
    assert (dm.nbytes(), dm.nbytes_maps_only(), dm.num_blocks, dm.vocab.num_attrs) == \
        (ref_dm.nbytes(), ref_dm.nbytes_maps_only(), ref_dm.num_blocks, ref_dm.vocab.num_attrs)
    bm = tb.build_bitmap_index(dims, CARDS, device="cpu")
    ref_bm = jb.build_bitmap_index(dims, CARDS)
    assert tb.build_ewah_index(bm).nbytes() == jb.build_ewah_index(ref_bm).nbytes()
