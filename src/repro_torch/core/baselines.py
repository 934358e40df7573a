"""First-to-k baselines the paper compares against (§7.1).

Counterpart of ``repro/core/baselines.py``:

* BITMAP-SCAN   — uncompressed per-value bitmaps, bitwise ⊕, first k set bits.
* LOSSY-BITMAP  — one bit per block per value (≡ DensityMap rounded up to 1).
* EWAH          — 64-bit word-aligned hybrid compressed bitmaps (run-length
                  markers + literal words), decompressed to scan.
* DISK-SCAN     — scan blocks in order until k valid records found (no index).
* BITMAP-RANDOM — k uniform random records among the valid set (gold standard
                  for aggregate estimation, §7.5).

Every index lives on one device as int64 word tensors whose bit patterns
equal the reference's uint64 words.  A bitmap is built with one
``index_add_`` of ``1 << bit`` per attribute: each record sets one bit per
attribute, so the sum of a word's terms is their OR (bit 63 is the int64
minimum, and adding it gives the same pattern).  Set bits are read from the
words' little-endian bytes unpacked, as the reference's ``np.unpackbits``
reads them.  EWAH runs as a vectorised run-length code whose streams equal
the reference's per-word loop bit for bit.  Scans return host ``(record_ids,
blocks)`` arrays, as the reference does, so the benchmark harness can
charge them I/O through the same cost model as the any-k algorithms.
``bitmap_random`` draws its sample on the host with the caller's numpy
Generator, the reference's draw, and gathers the chosen records on the
device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.density_map import AND, OR
from repro_torch.device import resolve_device

# 1 << b as int64 bit patterns, b = 0..63 (bit 63 is the int64 minimum)
_BITS = np.left_shift(np.uint64(1), np.arange(64, dtype=np.uint64)).view(np.int64)
_LOW32 = 0xFFFFFFFF
_RUN_MAX = (1 << 31) - 1  # the marker's run-length field
_CHUNK = 1 << 24  # records a build step handles at once
_SCAN_WORDS = 1 << 16  # words a first-k scan unpacks at once (4 Mi records)


def _bit_values(b: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_BITS).to(b.device)[b]


def _or_words(words: torch.Tensor, row_words: torch.Tensor, bit: torch.Tensor) -> None:
    """OR bit ``bit`` into ``words.view(-1)[row_words]``; no two terms of a
    call may set the same bit of a word (then the sum is the OR)."""
    words.view(-1).index_add_(0, row_words, _bit_values(bit))


# ----------------------------------------------------------------------------
# Uncompressed bitmap index
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class BitmapIndex:
    """One packed bitmap per (attr, value) row; rows addressed as in PredicateVocab."""

    bits: torch.Tensor  # [num_rows, ceil(N/64)] int64 (the reference's uint64 words)
    num_records: int
    attr_offsets: np.ndarray

    def nbytes(self) -> int:
        return int(self.bits.numel() * 8)

    def row(self, attr: int, value: int) -> torch.Tensor:
        return self.bits[int(self.attr_offsets[attr]) + int(value)]


def build_bitmap_index(dims, cards: Sequence[int], device: str | torch.device = "cuda"
                       ) -> BitmapIndex:
    """Bitmaps of an ``[N, r]`` dimension table (numpy, or a tensor such as
    a view of a store's slab), built on ``device``."""
    dev = resolve_device(device)
    dims = torch.as_tensor(dims).to(dev)
    n, r = dims.shape
    cards = np.asarray(cards, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(cards)])
    words = -(-n // 64)
    bits = torch.zeros((int(offsets[-1]), words), dtype=torch.int64, device=dev)
    for lo in range(0, n, _CHUNK):
        rec = torch.arange(lo, min(lo + _CHUNK, n), device=dev)
        for attr in range(r):
            rows = int(offsets[attr]) + dims[lo:lo + rec.numel(), attr].long()
            _or_words(bits, rows * words + rec // 64, rec % 64)
    return BitmapIndex(bits=bits, num_records=n, attr_offsets=offsets)


def _combine_words(row_of, predicates, op: str) -> torch.Tensor:
    acc = None
    for attr, value in predicates:
        row = row_of(attr, value)
        if acc is None:
            acc = row.clone()
        elif op == AND:
            acc &= row
        elif op == OR:
            acc |= row
        else:
            raise ValueError(op)
    if acc is None:
        raise ValueError("no predicates")
    return acc


def combine_bitmaps(index: BitmapIndex, predicates, op: str = AND) -> torch.Tensor:
    return _combine_words(index.row, predicates, op)


def _set_bits(words: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Positions of the set bits among the first ``num_bits``, ascending, on
    the words' device: each word's little-endian bytes unpacked low bit
    first (``np.unpackbits(words.view(np.uint8), bitorder="little")``)."""
    by = words.contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = ((by[:, None] >> shifts) & 1).view(-1)[:num_bits]
    return torch.nonzero(bits).view(-1)


def _first_k_set_bits(words: torch.Tensor, k: int, num_records: int) -> torch.Tensor:
    """First k set bit positions of a packed bitmap, unpacked a stretch of
    words at a time until k are found."""
    parts, got = [], 0
    for lo in range(0, words.numel(), _SCAN_WORDS):
        hi = min(lo + _SCAN_WORDS, words.numel())
        pos = _set_bits(words[lo:hi], max(num_records - 64 * lo, 0)) + 64 * lo
        parts.append(pos[:max(k - got, 0)])
        got += parts[-1].numel()
        if got >= k:
            break
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64, device=words.device)


def _scan_result(recs: torch.Tensor, records_per_block: int) -> tuple[np.ndarray, np.ndarray]:
    recs = recs.cpu().numpy().astype(np.int64)
    return recs, np.unique(recs // records_per_block)


def bitmap_scan(
    index: BitmapIndex, predicates, k: int, records_per_block: int, op: str = AND
) -> tuple[np.ndarray, np.ndarray]:
    """BITMAP-SCAN: first k valid record ids + the blocks they live in."""
    acc = combine_bitmaps(index, predicates, op)
    return _scan_result(_first_k_set_bits(acc, k, index.num_records), records_per_block)


def bitmap_random(
    index: BitmapIndex, predicates, k: int, records_per_block: int,
    rng: np.random.Generator, op: str = AND,
) -> tuple[np.ndarray, np.ndarray]:
    """BITMAP-RANDOM: k uniform random valid records (gold standard).  The
    draw is the reference's, on the host: ``rng.choice`` over the count of
    valid records; the chosen records are gathered on the device."""
    acc = combine_bitmaps(index, predicates, op)
    all_recs = _set_bits(acc, index.num_records)
    if all_recs.numel() == 0:
        return np.asarray([], dtype=np.int64), np.asarray([], dtype=np.int64)
    take = min(k, all_recs.numel())
    pick = rng.choice(all_recs.numel(), size=take, replace=False)
    recs = torch.sort(all_recs[torch.from_numpy(pick).to(all_recs.device)]).values
    return _scan_result(recs, records_per_block)


# ----------------------------------------------------------------------------
# LOSSY-BITMAP (block-level presence bits)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class LossyBitmapIndex:
    bits: torch.Tensor  # [num_rows, ceil(λ/64)] int64, 1 = block has >= 1 match
    num_blocks: int
    attr_offsets: np.ndarray

    def nbytes(self) -> int:
        return int(self.bits.numel() * 8)


def build_lossy_bitmap(densities: torch.Tensor, attr_offsets: np.ndarray) -> LossyBitmapIndex:
    """Presence bits of a ``[rows, λ]`` density tensor, on its device."""
    rows, lam = densities.shape
    words = -(-lam // 64)
    bits = torch.zeros((rows, words), dtype=torch.int64, device=densities.device)
    r, b = torch.nonzero(densities > 0.0, as_tuple=True)
    _or_words(bits, r * words + b // 64, b % 64)
    return LossyBitmapIndex(bits=bits, num_blocks=lam, attr_offsets=attr_offsets)


def lossy_bitmap_scan(index: LossyBitmapIndex, predicates, op: str = AND) -> np.ndarray:
    """Candidate block ids in storage order (caller fetches until k found)."""
    acc = _combine_words(lambda a, v: index.bits[int(index.attr_offsets[a]) + int(v)],
                         predicates, op)
    return _set_bits(acc, index.num_blocks).cpu().numpy().astype(np.int64)


# ----------------------------------------------------------------------------
# EWAH compressed bitmaps (64-bit word-aligned hybrid)
# ----------------------------------------------------------------------------
# Encoding: stream of 64-bit words.  A marker word holds (run_bit:1,
# run_len:31, num_literals:32); it is followed by num_literals literal words.
# The reference's compressor walks the words: a marker opens at a run of
# all-0 or all-1 words (or at word 0) and covers that run and the literal
# words after it.  Vectorised: a marker opens at word 0 and at every clean
# word whose predecessor is a literal or a clean word of the other kind.


def ewah_compress(words: torch.Tensor) -> torch.Tensor:
    """The reference's EWAH stream of ``[W]`` int64 words, on their device."""
    w = words.reshape(-1)
    n = w.numel()
    dev = w.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    ones = w == -1
    lit = ~(ones | (w == 0))
    kind = torch.where(lit, 2, ones.to(torch.int64))  # 0 zeros, 1 ones, 2 literal
    opens = torch.ones(n, dtype=torch.bool, device=dev)
    opens[1:] = ~lit[1:] & (kind[1:] != kind[:-1])
    group = torch.cumsum(opens, 0) - 1
    n_groups = int(group[-1]) + 1
    size = torch.bincount(group, minlength=n_groups)
    nlit = torch.bincount(group[lit], minlength=n_groups)
    run_len = (size - nlit).clamp(max=_RUN_MAX)
    head = torch.nonzero(opens).view(-1)
    run_bit = torch.where(ones[head], torch.iinfo(torch.int64).min, 0)
    marker = run_bit | (run_len << 32) | nlit
    lits_before = torch.cumsum(lit, 0) - lit.to(torch.int64)
    out = torch.empty(n_groups + int(lit.sum()), dtype=torch.int64, device=dev)
    out[torch.arange(n_groups, device=dev) + lits_before[head]] = marker
    out[(group + 1 + lits_before)[lit]] = w[lit]
    return out


def ewah_decompress(stream: torch.Tensor, num_words: int) -> torch.Tensor:
    """``[num_words]`` int64 words of an EWAH stream, on its device.

    The markers are the chain 0 → 1 + nlit(0) → ...: every position's
    "next marker if this were one" is known at once, and doubling the jumps
    finds the chain in log2(markers) + 1 steps.  Every other position is a literal
    of the marker before it.  Words past the stream's end stay 0, and
    anything a marker would write past ``num_words`` is dropped."""
    s = stream.reshape(-1)
    length = s.numel()
    dev = s.device
    out = torch.zeros(num_words, dtype=torch.int64, device=dev)
    if length == 0 or num_words == 0:
        return out
    pos = torch.arange(length, device=dev)
    jump = torch.cat([(pos + 1 + (s & _LOW32)).clamp(max=length),
                      torch.tensor([length], device=dev)])
    on = torch.zeros(length + 1, dtype=torch.bool, device=dev)
    on[0] = True
    for _ in range(max(length, 1).bit_length() + 1):
        reach = torch.zeros(length + 1, dtype=torch.int32, device=dev)
        reach.index_add_(0, jump, on.to(torch.int32))
        grown = on | (reach > 0)
        if torch.equal(grown, on):  # a step that adds nothing: the chain is whole
            break
        on = grown
        jump = jump[jump]
    on = on[:length]
    m = torch.nonzero(on).view(-1)
    mk = s[m]
    run_len = (mk >> 32) & _RUN_MAX
    nlit = mk & _LOW32
    start = torch.cumsum(run_len + nlit, 0) - (run_len + nlit)  # output word of each marker
    # runs of all-1 words: +1 at a run's start, -1 past its end
    ones = mk < 0
    edge = torch.zeros(num_words + 1, dtype=torch.int64, device=dev)
    edge.index_add_(0, start[ones].clamp(max=num_words), torch.ones_like(start[ones]))
    edge.index_add_(0, (start + run_len)[ones].clamp(max=num_words),
                    -torch.ones_like(start[ones]))
    out[torch.cumsum(edge, 0)[:num_words] > 0] = -1
    # literal words: the (p - m - 1)-th literal of their marker m
    lit = ~on
    owner = (torch.cumsum(on, 0) - 1)[lit]
    dst = start[owner] + run_len[owner] + (pos[lit] - m[owner] - 1)
    keep = dst < num_words
    out[dst[keep]] = s[lit][keep]
    return out


@dataclasses.dataclass
class EwahIndex:
    streams: list[torch.Tensor]
    num_records: int
    attr_offsets: np.ndarray

    def nbytes(self) -> int:
        return int(sum(s.numel() * 8 for s in self.streams))


def build_ewah_index(index: BitmapIndex) -> EwahIndex:
    streams = [ewah_compress(index.bits[r]) for r in range(index.bits.shape[0])]
    return EwahIndex(streams=streams, num_records=index.num_records,
                     attr_offsets=index.attr_offsets)


def ewah_scan(
    index: EwahIndex, predicates, k: int, records_per_block: int, op: str = AND
) -> tuple[np.ndarray, np.ndarray]:
    """EWAH baseline: decompress-and-combine, then first-k (word-aligned ops)."""
    num_words = -(-index.num_records // 64)
    acc = _combine_words(
        lambda a, v: ewah_decompress(index.streams[int(index.attr_offsets[a]) + int(v)],
                                     num_words),
        predicates, op)
    return _scan_result(_first_k_set_bits(acc, k, index.num_records), records_per_block)


# ----------------------------------------------------------------------------
# DISK-SCAN
# ----------------------------------------------------------------------------


def disk_scan(valid_mask, k: int, records_per_block: int) -> tuple[np.ndarray, np.ndarray]:
    """Scan blocks in storage order until k valid records are found.

    ``valid_mask``: ``[N]`` bool ground-truth validity (numpy or a tensor on
    its device; the scan reads the raw data, so it sees the truth, and it is
    charged I/O for *every* block up to the stop point).
    """
    valid_mask = torch.as_tensor(valid_mask)
    parts, got = [], 0
    for lo in range(0, valid_mask.numel(), 64 * _SCAN_WORDS):  # stop at the k-th
        parts.append(torch.nonzero(valid_mask[lo:lo + 64 * _SCAN_WORDS]).view(-1)[:k - got] + lo)
        got += parts[-1].numel()
        if got >= k:
            break
    recs = torch.cat(parts).cpu().numpy().astype(np.int64) if parts else np.zeros(0, np.int64)
    if recs.size == 0:
        last_block = (valid_mask.numel() - 1) // records_per_block
    else:
        last_block = int(recs[-1]) // records_per_block
    return recs, np.arange(0, last_block + 1, dtype=np.int64)
