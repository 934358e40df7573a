"""The record selection kernels (``csrc/record_select.cu``) against their plain version.

At the served path's shapes (8,192 rows a block, 8 dims, 2 or 20
measures, 1 to 20,000 pairs over a union whose blocks several pairs read,
γ 1 to 3 under AND and OR, a Predicate tree, all-invalid blocks) the
kernels' packed buffer and record count equal the plain version's on the
same slabs, bit for bit; and a traced device wave on the card launches one
count pass and one write pass a round, with every pair masked by the kernel
or by its tree.  The kernels need a card, so the cases carry the ``cuda``
marker and skip where there is none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_record_select_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import multi_query
from repro_torch.core import predicates as tp
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery, new_query_state
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.kernels import _lib
from repro_torch.kernels import record_select as rs
from repro_torch.obs import TraceRecorder

pytestmark = pytest.mark.cuda

RPB = 8192
CARDS = np.asarray([3, 2, 4, 7, 50, 11, 9, 7])  # TPC-H LINEITEM's eight dims
TREE = tp.Or((tp.Eq(1, 1), tp.And((tp.Eq(2, 0), tp.Not(tp.Eq(3, 1))))))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the record selection kernels run only there")
    return torch.device("cuda")


def _round(n_union: int, n_pairs: int, s: int, seed: int, rpb: int = RPB, cards=CARDS):
    """Union slabs on the host (past two blocks, the last two all invalid) and a
    round of 64 queries whose ``n_pairs`` pairs cover them: AND and OR, γ 1
    to 3, the third query a Predicate tree."""
    rng = np.random.default_rng(seed)
    dims = np.stack([rng.integers(0, c, (n_union, rpb)) for c in cards], -1).astype(np.int32)
    meas = rng.normal(0.0, 1.0, (n_union, rpb, s)).astype(np.float32)
    valid = rng.random((n_union, rpb)) > 0.01
    if n_union > 2:
        valid[-2:] = False
    n_q = min(64, n_pairs)
    sizes = np.full(n_q, n_pairs // n_q)
    sizes[:n_pairs % n_q] += 1
    queries, blocks = [], []
    for j, size in enumerate(sizes):
        if j == 2:
            queries.append((TREE, "and"))
        else:
            attrs = rng.choice(len(cards), size=int(rng.integers(1, 4)), replace=False)
            queries.append(([(int(a), int(rng.integers(0, min(cards[a], 3)))) for a in attrs],
                            "or" if j % 4 == 1 else "and"))
        blocks.append(np.sort(rng.choice(n_union, size=min(int(size), n_union), replace=False)))
    states = [new_query_state(BatchQuery(p, 10, op)) for p, op in queries]
    pos = np.concatenate(blocks).astype(np.int64)
    owner = np.repeat(np.arange(n_q), [b.size for b in blocks])
    attrs, vals, is_or = multi_query._predicate_table(states)
    trees = [p if isinstance(p, tp.Predicate) else None for p, _ in queries]
    slabs = tuple(torch.from_numpy(a) for a in (dims, meas, valid))
    return slabs, (pos, owner, attrs, vals, is_or, trees)


@pytest.mark.parametrize("n_union,n_pairs,s", [(1, 1, 20), (226, 340, 2), (64, 1_000, 20),
                                               (1_024, 20_000, 20), (1_024, 20_000, 2)])
def test_kernels_pack_the_plain_records(cuda, n_union, n_pairs, s):
    (dims, meas, valid), args = _round(n_union, n_pairs, s, seed=n_pairs + s)
    pos = args[0]
    plain = rs.record_select(dims, valid, *args, multi_query._PAIR_CHUNK)
    want = rs.record_pack(plain, meas)
    d_dims, d_meas, d_valid = (t.to(cuda) for t in (dims, meas, valid))
    before = dict(_lib.LAUNCHES)
    sel = rs.record_select(d_dims, d_valid, *args, multi_query._PAIR_CHUNK)
    got = rs.record_pack(sel, d_meas)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["record_select"] == before["record_select"] + 1
    assert _lib.LAUNCHES["record_pack"] == before["record_pack"] + 1
    assert sel.n == plain.n > 0
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    trees = int((args[1] == 2).sum())  # the tree query's pairs
    assert (sel.kernel_pairs, sel.tree_pairs) == (pos.size - trees, trees)


@pytest.mark.parametrize("width", [4, 5, 12, 16])
def test_kernels_pack_the_plain_records_at_other_widths_and_ragged_blocks(cuda, width):
    """Rows of 4, 12 and 16 dims take the 16-byte loads, 5 the 4-byte ones;
    1,000 rows a block leave a partial mask word and a partial tile."""
    cards = np.resize(CARDS, width)
    (dims, meas, valid), args = _round(40, 300, 3, seed=width, rpb=1_000, cards=cards)
    plain = rs.record_select(dims, valid, *args, multi_query._PAIR_CHUNK)
    want = rs.record_pack(plain, meas)
    d_dims, d_meas, d_valid = (t.to(cuda) for t in (dims, meas, valid))
    sel = rs.record_select(d_dims, d_valid, *args, multi_query._PAIR_CHUNK)
    assert sel.n == plain.n > 0
    assert rs.record_pack(sel, d_meas).cpu().numpy().tobytes() == want.numpy().tobytes()


def test_a_round_with_no_match(cuda):
    (dims, meas, valid), (pos, owner, attrs, vals, is_or, trees) = _round(8, 40, 2, seed=3)
    valid[:] = False
    d = [t.to(cuda) for t in (dims, meas, valid)]
    sel = rs.record_select(d[0], d[2], pos, owner, attrs, vals, is_or, trees, 4096)
    got = rs.record_pack(sel, d[1])
    assert sel.n == 0 and got.numel() == 0
    assert rs.record_select(dims, valid, pos, owner, attrs, vals, is_or, trees, 4096).n == 0


def test_a_traced_wave_launches_one_count_and_one_write_a_round(cuda):
    """The device wave on the card equals the CPU's, record for record; each
    ``wave.records`` span is one count pass and one write pass, and its
    pairs are the kernel's and the tree's."""
    rng = np.random.default_rng(11)
    n = 40 * RPB - 123
    dims = np.stack([rng.integers(0, c, n) for c in CARDS], 1).astype(np.int32)
    meas = rng.normal(0.0, 1.0, (n, 20)).astype(np.float32)
    table = Table(dims, meas, CARDS)
    queries = [BatchQuery([(0, 1), (1, 0), (3, 2)], 4_000),
               BatchQuery([(4, 7), (5, 3)], 900, "or"), BatchQuery(TREE, 20_000),
               BatchQuery([(2, 1)], 30_000)]
    cpu = NeedleTailEngine(build_block_store(table, RPB, device="cpu"),
                           device="cpu").any_k_batch(queries, device=True)
    rec = TraceRecorder()
    eng = NeedleTailEngine(build_block_store(table, RPB, device="cuda"), obs=rec, device="cuda")
    _lib.reset_launches()
    out = eng.any_k_batch(queries, device=True)
    spans = [e["attrs"] for e in rec.to_events()
             if e["kind"] == "span" and e["name"] == "wave.records"]
    assert len(spans) == out.rounds > 0
    assert _lib.LAUNCHES["record_select"] == _lib.LAUNCHES["record_pack"] == out.rounds
    assert all(a["kernel_pairs"] + a["tree_pairs"] == a["pair_rows"] // RPB for a in spans)
    assert sum(a["tree_pairs"] for a in spans) == out.results[2].blocks_fetched.size > 0
    assert all(a["d2h_copies"] == 1 and a["d2h_bytes"] == 96 * a["records"] for a in spans)
    for a, b in zip(out.results, cpu.results):
        np.testing.assert_array_equal(a.record_block, b.record_block)
        np.testing.assert_array_equal(a.record_row, b.record_row)
        assert a.measures.tobytes() == b.measures.tobytes()
