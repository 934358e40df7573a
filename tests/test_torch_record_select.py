"""A round's record selection and packing (``kernels.record_select``) on the CPU.

The plain version (``record_select`` and ``record_pack`` on CPU tensors)
and ``multi_query._wave_records`` are held, bit for bit, to a numpy model
of the op chain the kernels replaced: each (query, block) pair's fold of its
``(attr, value)`` tests (AND from ``True``, OR from ``False``, padded slots
the identity) or its Predicate tree's own mask, ANDed with the valid rows,
then the records in (pair, row) order packed as pair index and row (int64)
and the measures' float32 bits.  The kernels' own data plan is checked by a
numpy walk of the same steps over ``kernel_table``'s buffer: the pairs of
each union block, each warp's 32 rows as one mask word, the counts' scan
and the rows expanded from the words.  Cases: AND and OR pair lists, padded
slots, a Predicate tree beside pair lists, invalid rows, a round with no
match and pairs that repeat a union block, each at s = 2 and 20.  The
kernels themselves run on the card only (``test_torch_record_select_card.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import multi_query
from repro_torch.core import predicates as tp
from repro_torch.core.multi_query import BatchQuery, new_query_state
from repro_torch.kernels import record_select as rs

U, R, WIDTH = 12, 64, 4
CASES = ["and", "or", "padded", "tree", "invalid", "none", "repeat"]


def _queries(case: str, rng) -> list:
    """``(predicates, op)`` of a case's queries."""
    if case == "and":
        return [([(0, 1), (1, 2)], "and"), ([(2, 0), (3, 1), (0, 2)], "and"), ([(1, 1)], "and")]
    if case == "or":
        return [([(0, 1), (1, 2)], "or"), ([(2, 0), (3, 2), (0, 0)], "or"), ([(3, 1)], "or")]
    if case == "tree":
        tree = tp.Or((tp.Eq(1, 1), tp.And((tp.Eq(2, 0), tp.Not(tp.Eq(3, 1))))))
        return [([(0, 1), (1, 2)], "and"), (tree, "and"), ([(2, 1), (3, 0)], "or")]
    if case == "none":  # A0 = 1 and A0 = 2: no row meets either query
        return [([(0, 1), (0, 2)], "and"), ([(1, 0), (1, 1), (2, 2)], "and")]
    # padded, invalid, repeat: γ 1 to 3 under both ops, so short queries pad
    return [([(0, 1)], "and"), ([(1, 2), (2, 0), (3, 1)], "and"), ([(0, 0), (3, 2)], "or"),
            ([(2, 1)], "or")]


def _round(case: str, s: int):
    """A round's union slabs, its queries and their blocks (union ids,
    ascending; in ``repeat`` every query reads the same three blocks)."""
    rng = np.random.default_rng(CASES.index(case) * 7 + s)
    dims = rng.integers(0, 3, (U, R, WIDTH)).astype(np.int32)
    meas = rng.normal(0.0, 1.0, (U, R, s)).astype(np.float32)
    valid = np.ones((U, R), bool)
    if case == "invalid":
        valid[3] = False  # a whole padded block
        valid[-1, R // 3:] = False  # the store's last, partial block
        valid[5, rng.random(R) < 0.25] = False
    queries = _queries(case, rng)
    if case == "repeat":
        blocks = [np.asarray([2, 5, 9]) for _ in queries]
    else:
        blocks = [np.sort(rng.choice(U, size=int(rng.integers(3, 8)), replace=False))
                  for _ in queries]
    return torch.from_numpy(dims), torch.from_numpy(meas), torch.from_numpy(valid), queries, blocks


def _inputs(queries, blocks):
    """What ``_wave_records`` hands the wrapper: pairs' union ids and
    queries, the tests' table and the trees."""
    states = [new_query_state(BatchQuery(p, 10, op)) for p, op in queries]
    pos = np.concatenate(blocks).astype(np.int64)
    owner = np.repeat(np.arange(len(states)), [b.size for b in blocks])
    attrs, vals, is_or = multi_query._predicate_table(states)
    trees = [p if isinstance(p, tp.Predicate) else None for p, _ in queries]
    return states, pos, owner, attrs, vals, is_or, trees


def _pair_mask(dims, valid, u: int, pred, op: str) -> np.ndarray:
    """The model of one pair's mask over union block ``u``."""
    if isinstance(pred, tp.Predicate):
        m = pred.mask(dims[u]).numpy().copy()
    else:
        m = np.full(R, op == "and")
        for a, v in pred:
            eq = dims[u, :, a].numpy() == v
            m = m | eq if op == "or" else m & eq
    return m & valid[u].numpy()


def _model(dims, meas, valid, queries, blocks) -> tuple[int, np.ndarray]:
    """The numpy model: the round's record count and its packed buffer."""
    pair_ids, rows = [], []
    i = 0
    for (pred, op), b in zip(queries, blocks):
        for u in b:
            hit = np.flatnonzero(_pair_mask(dims, valid, int(u), pred, op))
            pair_ids.append(np.full(hit.size, i, np.int64))
            rows.append(hit.astype(np.int64))
            i += 1
    pair, row = np.concatenate(pair_ids), np.concatenate(rows)
    pos = np.concatenate(blocks)
    n, s = pair.size, meas.shape[2]
    packed = np.empty(n * (4 + s), np.int32)
    packed[:2 * n].view(np.int64)[:] = pair
    packed[2 * n:4 * n].view(np.int64)[:] = row
    packed[4 * n:] = meas.numpy()[pos[pair], row].view(np.int32).ravel()
    return n, packed


def _kernels_walk(dims, meas, valid, table, at, tree_rows, n_pairs: int, gamma: int, s: int):
    """The kernels' steps in numpy, reading ``kernel_table``'s buffer as the
    count pass does (``P`` and ``G`` as the launch passes them): returns the
    record count and the packed buffer."""
    t = table.numpy()
    n_union = dims.shape[0]
    pos, owner, tree = (t[a:a + n_pairs] for a in at[:3])
    ub_off, ub_pairs = t[at[3]:at[3] + n_union + 1], t[at[4]:at[4] + n_pairs]
    attrs = t[at[5]:at[6]]
    is_or = t[at[6]:at[6] + attrs.size // gamma]
    vals = t[at[7]:at[7] + 2 * attrs.size].view(np.int64)
    words, tiles = -(-R // 32), -(-R // 1024)
    bits = np.zeros((n_pairs, words), np.uint32)
    tile_counts = np.zeros((n_pairs, tiles), np.int64)
    for u in range(n_union):  # a union block's pairs, each masked from one read
        d, ok = dims[u].numpy(), valid[u].numpy()
        for p in ub_pairs[ub_off[u]:ub_off[u + 1]]:
            if tree[p] >= 0:
                m = tree_rows[tree[p]].numpy() & ok
            else:
                q = owner[p]
                m = np.full(R, not is_or[q])
                for a, v in zip(attrs[q * gamma:(q + 1) * gamma], vals[q * gamma:(q + 1) * gamma]):
                    if a >= 0:
                        m = m | (d[:, a] == v) if is_or[q] else m & (d[:, a] == v)
                m &= ok
            padded = np.zeros(words * 32, bool)
            padded[:R] = m
            bits[p] = (padded.reshape(words, 32) << np.arange(32)).sum(1).astype(np.uint32)
            tile_counts[p] = [m[i * 1024:(i + 1) * 1024].sum() for i in range(tiles)]
    offsets = np.concatenate([[0], np.cumsum(tile_counts.sum(1))])
    n = int(offsets[-1])
    packed = np.empty(n * (4 + s), np.int32)
    for p in range(n_pairs):  # a pair's rows from its words, ascending
        b0 = offsets[p]
        word_bits = (bits[p][:, None] >> np.arange(32)) & 1
        rows = np.flatnonzero(word_bits.ravel())
        packed[:2 * n].view(np.int64)[b0:b0 + rows.size] = p
        packed[2 * n:4 * n].view(np.int64)[b0:b0 + rows.size] = rows
        packed[4 * n:].reshape(n, s)[b0:b0 + rows.size] = meas[pos[p]].numpy()[rows].view(np.int32)
    return n, packed


@pytest.mark.parametrize("chunk", [multi_query._PAIR_CHUNK, 2])
@pytest.mark.parametrize("s", [2, 20])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_packs_the_model_records(case, s, chunk):
    dims, meas, valid, queries, blocks = _round(case, s)
    _, pos, owner, attrs, vals, is_or, trees = _inputs(queries, blocks)
    sel = rs.record_select(dims, valid, pos, owner, attrs, vals, is_or, trees, chunk)
    packed = rs.record_pack(sel, meas)
    n, want = _model(dims, meas, valid, queries, blocks)
    assert (case == "none") == (n == 0)
    assert sel.n == n and sel.pairs == pos.size and packed.dtype == torch.int32
    assert packed.numpy().tobytes() == want.tobytes()
    assert sel.kernel_pairs == 0  # the CPU runs the plain version, never the kernel
    assert sel.tree_pairs == (blocks[1].size if case == "tree" else 0)


@pytest.mark.parametrize("s", [2, 20])
@pytest.mark.parametrize("case", CASES)
def test_kernels_data_plan_gives_the_same_buffer(case, s):
    """``kernel_table``'s buffer walked as the kernels walk it (each union
    block once for every pair that reads it, mask words, the scan, the rows
    expanded in order) packs what the plain version packs."""
    dims, meas, valid, queries, blocks = _round(case, s)
    _, pos, owner, attrs, vals, is_or, trees = _inputs(queries, blocks)
    table, at, tree_rows = rs.kernel_table(dims, pos, owner, attrs, vals, is_or, trees)
    assert table.dtype == torch.int32 and at[7] % 2 == 0
    assert (tree_rows is None) == (case != "tree")
    n, got = _kernels_walk(dims, meas, valid, table, at, tree_rows, pos.size, attrs.shape[1], s)
    sel = rs.record_select(dims, valid, pos, owner, attrs, vals, is_or, trees, 4096)
    assert n == sel.n
    assert got.tobytes() == rs.record_pack(sel, meas).numpy().tobytes()


@pytest.mark.parametrize("case", CASES)
def test_wave_records_split_the_model_records(case):
    """``_wave_records`` returns each query's (block, row, measures) of the
    model, in its blocks' order, whatever the chunk."""
    dims, meas, valid, queries, blocks = _round(case, 20)
    states, *_ = _inputs(queries, blocks)
    union = np.arange(U, dtype=np.int64) * 3 + 1  # union ids are block ids; pos their index
    block_ids = [union[b] for b in blocks]
    n, packed = _model(dims, meas, valid, queries, blocks)
    pair = packed[:2 * n].view(np.int64)
    row = packed[2 * n:4 * n].view(np.int64)
    got_meas = packed[4 * n:].view(np.float32).reshape(n, 20)
    bounds = np.concatenate([[0], np.cumsum([b.size for b in blocks])])
    for chunk in (multi_query._PAIR_CHUNK, 3):
        saved, multi_query._PAIR_CHUNK = multi_query._PAIR_CHUNK, chunk
        try:
            out = multi_query._wave_records((dims, meas, valid), union, states, block_ids)
        finally:
            multi_query._PAIR_CHUNK = saved
        for j, (rb, rr, rm) in enumerate(out):
            sel = (pair >= bounds[j]) & (pair < bounds[j + 1])
            np.testing.assert_array_equal(rb, np.concatenate(block_ids)[pair[sel]])
            np.testing.assert_array_equal(rr, row[sel])
            assert rm.tobytes() == got_meas[sel].tobytes()
            assert rb.dtype == rr.dtype == np.int64 and rm.dtype == np.float32


def test_a_tensor_off_the_cpu_takes_the_kernel_or_raises():
    """Only CPU tensors take the plain version: any other device goes to
    the kernel's checks, which raise where there is no CUDA card."""
    dims, meas, valid, queries, blocks = _round("and", 2)
    _, pos, owner, attrs, vals, is_or, trees = _inputs(queries, blocks)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rs.record_select(dims.to("meta"), valid.to("meta"), pos, owner, attrs, vals, is_or,
                         trees, 4096)
    sel = rs.record_select(dims, valid, pos, owner, attrs, vals, is_or, trees, 4096)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rs.record_pack(rs.Selection(sel.n, sel.pairs, 0, 0, bits=dims.to("meta"),
                                    offsets=dims.to("meta"), table=dims.to("meta")),
                       meas.to("meta"))
