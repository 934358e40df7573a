"""A round's record selection and packing over the union slabs.

Added by the port, with no Pallas counterpart: the reference masks each
query's blocks with the store's ``predicate_mask`` and finds and gathers
its records with numpy on the host.  The device wave holds a
round's union slabs ``(dims [U, R, r], measures [U, R, s], valid [U, R])``
on the card; each pair's mask is the reference's ``predicate_mask`` fold
(AND over its query's ``(attr, value)`` tests from ``True``, OR from
``False``; padded slots, attr -1, are the identity), or for a Predicate
tree its own ``mask`` over the pair's block, ANDed with the valid rows.

Two steps, so a caller can time them apart:

* :func:`record_select` masks every pair and counts the round's records
  ``n`` (the one value the host reads back);
* :func:`record_pack` writes the records into one int32 buffer of
  ``n·(4 + s)`` words: each record's round-wide pair index, then its row
  (int64 each, ``[n]``), then its measures' float32 bits ``[n, s]``, pairs
  in order and rows ascending within a pair (``nonzero``'s order).

On CUDA they are the kernels in ``csrc/record_select.cu`` (a count pass
over each union block once, whatever the pairs that read it, and a scan,
counted as ``record_select``; a write pass, ``record_pack``), one launch
each a round.  On the CPU they are :func:`record_select_plain` and
:func:`record_pack_plain`, the op chain the kernels replaced, which masks
``chunk`` pairs at a time.  Both give the same buffer bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _lib
from repro_torch.obs.trace import span_or_null


@dataclasses.dataclass
class Selection:
    """A round's masks, before packing.  ``n`` records over ``pairs``
    pairs; ``kernel_pairs`` were masked from their query's (attr, value)
    table by the kernel (0 on the CPU), ``tree_pairs`` took their Predicate
    tree's own mask.  The rest is the packing step's input: the plain
    version's ``chunks`` of ``(first pair, pair union ids, [m, 2] hits)``;
    the kernel's mask words, offsets and uploaded table."""

    n: int
    pairs: int
    kernel_pairs: int
    tree_pairs: int
    chunks: list | None = None
    bits: torch.Tensor | None = None
    offsets: torch.Tensor | None = None
    table: torch.Tensor | None = None


def _trees_of(trees, owner: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(per query: is it a tree, per pair: does it take a tree's mask)."""
    is_tree = np.asarray([t is not None for t in trees], dtype=bool)
    return is_tree, is_tree[owner] if owner.size else np.zeros(0, bool)


def record_select_plain(dims_u, valid_u, pos, owner, attrs, vals, is_or, trees, chunk: int,
                        obs=None) -> Selection:
    """Plain PyTorch version: the masks of ``chunk`` pairs at a time (a
    ``records.select`` span each), each chunk's records found by a
    synchronising ``nonzero``; any device."""
    dev = dims_u.device
    r = dims_u.shape[1]
    is_tree, tree_pair = _trees_of(trees, owner)
    rows_idx = torch.arange(r, device=dev)[None, :]
    chunks = []
    for lo in range(0, pos.size, chunk):
        with span_or_null(obs, "records.select"):
            p = torch.from_numpy(pos[lo:lo + chunk]).to(dev)
            own = owner[lo:lo + chunk]
            a_p = torch.from_numpy(attrs[own]).to(dev)  # [P, γ_max]
            v_p = torch.from_numpy(vals[own]).to(dev)
            acc_and = torch.ones((p.numel(), r), dtype=torch.bool, device=dev)
            acc_or = torch.zeros_like(acc_and)
            for g in range(attrs.shape[1]):
                pad = (a_p[:, g] < 0)[:, None]
                col = dims_u[p[:, None], rows_idx, a_p[:, g].clamp(min=0)[:, None]]
                eq = col == v_p[:, g][:, None]
                acc_and &= eq | pad
                acc_or |= eq & ~pad
            or_p = torch.from_numpy(is_or[own]).to(dev)[:, None]
            mask = torch.where(or_p, acc_or, acc_and)
            for j in np.unique(own[is_tree[own]]):
                sel = torch.from_numpy(np.flatnonzero(own == j)).to(dev)
                mask[sel] = trees[j].mask(dims_u[p[sel]])
            mask &= valid_u[p]
            hit = torch.nonzero(mask)  # [n, 2] (pair, row), row-major order
            chunks.append((lo, p, hit))
    n = sum(int(hit.shape[0]) for _, _, hit in chunks)
    return Selection(n, int(pos.size), 0, int(tree_pair.sum()), chunks=chunks)


def record_pack_plain(sel: Selection, meas_u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the records of ``sel``'s chunks packed into
    one int32 buffer; any device."""
    n, s = sel.n, meas_u.shape[2]
    # int32 words: the round's pair indices, then the rows (int64 each),
    # then the measures' float32 bits [n, s]
    packed = torch.empty(n * (4 + s), dtype=torch.int32, device=meas_u.device)
    pair_col = packed[:2 * n].view(torch.int64)
    row_col = packed[2 * n:4 * n].view(torch.int64)
    meas_col = packed[4 * n:].view(n, s)
    o = 0
    for lo, p, hit in sel.chunks:
        m = hit.shape[0]
        torch.add(hit[:, 0], lo, out=pair_col[o:o + m])
        row_col[o:o + m].copy_(hit[:, 1])
        meas_col[o:o + m].copy_(meas_u[p[hit[:, 0]], hit[:, 1]].view(torch.int32))
        o += m
    return packed


def kernel_table(dims_u, pos, owner, attrs, vals, is_or, trees):
    """The count pass's inputs beside the slabs, on ``dims_u``'s device.

    Returns ``(table, at, tree_rows)``: one int32 buffer, copied to the
    device once, of ``pos``, ``owner`` and ``tree`` (each pair's row of
    ``tree_rows``, or -1) ``[P]``, the pairs of each union block as CSR
    offsets ``[U + 1]`` and pair ids ``[P]``, ``attrs [J, G]``, ``is_or
    [J]``, then ``vals [J, G]`` int64 at an 8-byte offset; the parts'
    offsets in int32 words, in that order; and ``[T, R]`` bool, the tree
    pairs' own masks in pair order (``None`` without one)."""
    dev = dims_u.device
    n_union = dims_u.shape[0]
    _, tree_pair = _trees_of(trees, owner)
    tree_at = np.flatnonzero(tree_pair)
    tree = np.full(pos.size, -1, np.int64)
    tree[tree_at] = np.arange(tree_at.size)
    order = np.argsort(pos, kind="stable")
    ub_off = np.zeros(n_union + 1, np.int64)
    np.cumsum(np.bincount(pos, minlength=n_union), out=ub_off[1:])
    parts = [pos, owner, tree, ub_off, order, attrs.ravel(), is_or.astype(np.int32)]
    starts = np.concatenate([[0], np.cumsum([p.size for p in parts])]).tolist()
    vals_at = starts[-1] + starts[-1] % 2
    buf = np.zeros(vals_at + 2 * vals.size, np.int32)
    for part, a, b in zip(parts, starts[:-1], starts[1:]):
        buf[a:b] = part
    buf[vals_at:].view(np.int64)[:] = vals.ravel()
    tree_rows = None
    if tree_at.size:  # each tree's own mask over its pairs' blocks
        tree_rows = torch.empty((tree_at.size, dims_u.shape[1]), dtype=torch.bool, device=dev)
        for j in np.unique(owner[tree_at]):
            sel = tree_at[owner[tree_at] == j]
            at = torch.from_numpy(np.searchsorted(tree_at, sel)).to(dev)
            tree_rows[at] = trees[j].mask(dims_u[torch.from_numpy(pos[sel]).to(dev)])
    return torch.from_numpy(buf).to(dev), starts[:-1] + [vals_at], tree_rows


@_lib.no_gradient
def record_select(dims_u: torch.Tensor, valid_u: torch.Tensor, pos: np.ndarray,
                  owner: np.ndarray, attrs: np.ndarray, vals: np.ndarray, is_or: np.ndarray,
                  trees: list, chunk: int, obs=None) -> Selection:
    """Mask a round's ``P`` pairs and count their records.

    ``dims_u [U, R, r]`` int32 and ``valid_u [U, R]`` bool (or int8) are the
    union slabs; ``pos [P]`` each pair's union block and ``owner [P]`` its
    query (pairs grouped by query); ``attrs`` / ``vals [J, G]`` int64 and
    ``is_or [J]`` bool each query's tests, attr -1 a padded slot;
    ``trees [J]`` each query's Predicate tree, or ``None`` for a pair list.
    ``chunk`` pairs a launch group on the CPU; the kernel takes the round
    at once.  With ``obs`` the masks are ``records.select`` spans (one a
    chunk on the CPU, one a round on the card)."""
    if dims_u.device.type == "cpu":
        return record_select_plain(dims_u, valid_u, pos, owner, attrs, vals, is_or, trees,
                                   chunk, obs)
    with span_or_null(obs, "records.select"):
        dims_u, valid_u = dims_u.contiguous(), valid_u.contiguous()
        _lib.require_cuda("record_select", dims_u, valid_u)
        if dims_u.dtype != torch.int32 or dims_u.dim() != 3:
            raise ValueError("dims_u must be a [U, R, r] int32 tensor")
        if valid_u.element_size() != 1 or valid_u.shape != dims_u.shape[:2]:
            raise ValueError("valid_u must be a [U, R] bool or int8 tensor")
        width = dims_u.shape[2]
        if attrs.size and int(attrs.max()) >= width:
            raise ValueError(f"an attribute is past the slabs' {width} dims")
        n_pairs = int(pos.size)
        table, at, tree_rows = kernel_table(dims_u, pos, owner, attrs, vals, is_or, trees)
        bits, offsets = select_launch(dims_u, valid_u, table, at, tree_rows, n_pairs,
                                      attrs.shape[1])
        n = int(offsets[n_pairs])  # the round's one read back before the records
        n_tree = 0 if tree_rows is None else tree_rows.shape[0]
        return Selection(n, n_pairs, n_pairs - n_tree, n_tree, bits=bits, offsets=offsets,
                         table=table)


def select_launch(dims_u, valid_u, table, at, tree_rows, n_pairs: int, gamma: int):
    """The count pass and the scan over checked CUDA slabs and
    :func:`kernel_table`'s output, one launch with no synchronisation.
    Returns ``(bits [P, ceil(R/32)] int32, offsets [P + 1] int64)``."""
    n_union, rows, width = dims_u.shape
    dev = dims_u.device
    bits = torch.empty((n_pairs, -(-rows // 32)), dtype=torch.int32, device=dev)
    tile_counts = torch.empty((n_pairs, -(-rows // 1024)), dtype=torch.int32, device=dev)
    offsets = torch.empty(n_pairs + 1, dtype=torch.int64, device=dev)
    ptr = table.data_ptr()
    lib = _lib.load()
    with torch.cuda.device(dev):
        rc = lib.nt_record_select(
            dims_u.data_ptr(), valid_u.data_ptr(),
            None if tree_rows is None else tree_rows.data_ptr(),
            *(ptr + 4 * a for a in at), n_pairs, n_union, rows, width, gamma,
            bits.data_ptr(), tile_counts.data_ptr(), offsets.data_ptr(), _lib.stream_of(dims_u),
        )
    _lib.launched("record_select", rc)
    return bits, offsets


def pack_launch(bits, offsets, table, meas_u, n: int) -> torch.Tensor:
    """The write pass over :func:`select_launch`'s output and a checked
    ``[U, R, s]`` float32 CUDA slab, ``n`` records: one launch with no
    synchronisation; returns the packed buffer."""
    s = meas_u.shape[2]
    packed = torch.empty(n * (4 + s), dtype=torch.int32, device=meas_u.device)
    lib = _lib.load()
    with torch.cuda.device(meas_u.device):
        rc = lib.nt_record_pack(
            bits.data_ptr(), offsets.data_ptr(), table.data_ptr(), meas_u.data_ptr(),
            bits.shape[0], meas_u.shape[1], s, n, packed.data_ptr(), _lib.stream_of(meas_u),
        )
    _lib.launched("record_pack", rc)
    return packed


@_lib.no_gradient
def record_pack(sel: Selection, meas_u: torch.Tensor) -> torch.Tensor:
    """The records of ``sel`` from ``meas_u [U, R, s]`` float32, packed into
    one int32 device buffer of ``n·(4 + s)`` words (see the module)."""
    if meas_u.device.type == "cpu":
        return record_pack_plain(sel, meas_u)
    meas_u = meas_u.contiguous()
    _lib.require_cuda("record_pack", meas_u, sel.bits, sel.offsets, sel.table)
    if meas_u.dtype != torch.float32 or meas_u.dim() != 3:
        raise ValueError("meas_u must be a [U, R, s] float32 tensor")
    return pack_launch(sel.bits, sel.offsets, sel.table, meas_u, sel.n)
