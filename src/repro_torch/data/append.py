"""Incremental index maintenance: append records to a BlockStore without a
full rebuild.

Counterpart of ``repro/data/append.py``, on the store's device.  The
reference flattens the whole store to the host and uploads it again; here
the valid prefix of the store's slabs and the uploaded new rows are
written once into the successor's slabs on the card, and only the trailing
partial block and the newly created blocks have their density columns
recomputed (counts by ``bincount`` on the card; ``count / rpb`` in f64,
then rounded to f32, as numpy's ``dens[...] = c / rpb`` does).  The
untouched column prefix is reused, and the per-row *sorted* maps are
re-sorted by ``-dens`` with stable sorts, the port's rule.

:func:`rebuild_store` is the shared re-blocking core: append (this module)
and tail compaction (:mod:`repro_torch.storage.compact`) both hand it
the valid rows, in parts, plus the touched block ids and get back a successor
store with the listeners carried over; the caller decides what is dirty
and notifies.  While it runs, the old and the new slabs both live on the
device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.data.block_store import BlockStore, Table


def dirtied_block_ids(store: BlockStore, num_new: int) -> np.ndarray:
    """Block ids an append of ``num_new`` records rewrites or creates: the
    trailing partial block plus every newly created block."""
    rpb = store.records_per_block
    first_touched = store.num_records // rpb
    lam_new = -(-(store.num_records + num_new) // rpb)
    return np.arange(first_touched, lam_new, dtype=np.int64)


def valid_rows_flat(store: BlockStore) -> tuple[torch.Tensor, torch.Tensor]:
    """Views of the store's valid rows: ``[N, r]`` dims, ``[N, s]`` measures."""
    n = store.num_records
    return (store.dims.reshape(-1, store.dims.shape[-1])[:n],
            store.measures.reshape(-1, store.measures.shape[-1])[:n])


def rebuild_store(
    store: BlockStore,
    dims_parts: Sequence[torch.Tensor],
    meas_parts: Sequence[torch.Tensor],
    touched: np.ndarray,
) -> BlockStore:
    """Re-block flattened valid rows, given as consecutive ``[n_i, r]`` /
    ``[n_i, s]`` parts on the store's device (each written once into the
    successor's slabs), into a successor of ``store``: same schema and
    records per block, density columns recomputed only for the ``touched``
    block ids (ascending), invalidation listeners carried over.  Callers
    notify ``store``'s listeners with the dirtied ids themselves."""
    rpb = store.records_per_block
    dev = store.device
    r, s_ = store.dims.shape[-1], store.measures.shape[-1]
    n = sum(int(p.shape[0]) for p in dims_parts)
    lam_new = -(-n // rpb)
    dims_b = torch.full((lam_new * rpb, r), -1, dtype=torch.int32, device=dev)
    meas_b = torch.zeros((lam_new * rpb, s_), dtype=torch.float32, device=dev)
    lo = 0
    for d, m in zip(dims_parts, meas_parts):
        dims_b[lo:lo + d.shape[0]] = d
        meas_b[lo:lo + d.shape[0]] = m
        lo += d.shape[0]
    valid_b = torch.zeros(lam_new * rpb, dtype=torch.bool, device=dev)
    valid_b[:n] = True
    dims_b = dims_b.reshape(lam_new, rpb, r)

    # density columns: reuse the untouched prefix, count only touched blocks
    idx = store.index
    touched = np.asarray(touched, dtype=np.int64)
    first = int(touched[0]) if touched.size else lam_new
    rows = idx.vocab.num_rows
    dens = torch.zeros((rows, lam_new), dtype=torch.float32, device=dev)
    dens[:, :first] = idx.densities[:, :first]
    if touched.size:
        t_ids = torch.from_numpy(touched).to(dev)
        blk = dims_b[t_ids].long()  # [T, R, r]
        col = torch.arange(touched.size, device=dev)[:, None].expand(-1, rpb)
        off = torch.from_numpy(np.asarray(idx.vocab.attr_offsets, np.int64)).to(dev)
        counts = torch.zeros(rows * touched.size, dtype=torch.int64, device=dev)
        for attr in range(r):
            v = blk[:, :, attr]
            keep = v >= 0
            key = (off[attr] + v[keep]) * touched.size + col[keep]
            counts += torch.bincount(key, minlength=rows * touched.size)
        frac = (counts.reshape(rows, touched.size).to(torch.float64) / rpb).to(torch.float32)
        dens[:, t_ids] = frac
    order = torch.sort(-dens, dim=1, stable=True).indices
    new_index = dataclasses.replace(
        idx,
        densities=dens,
        sorted_block_ids=order.to(torch.int32),
        sorted_densities=torch.gather(dens, 1, order),
        num_records=n,
    )
    rebuilt = BlockStore(
        dims=dims_b,
        measures=meas_b.reshape(lam_new, rpb, s_),
        valid_rows=valid_b.reshape(lam_new, rpb),
        index=new_index,
        records_per_block=rpb,
        num_records=n,
    )
    rebuilt._invalidation_listeners = list(store._invalidation_listeners)
    return rebuilt


def append_records(store: BlockStore, new: Table) -> BlockStore:
    """A new BlockStore with ``new``'s rows appended (same schema), built on
    the store's device.  Listeners registered on ``store`` are notified with
    the dirtied tail block ids (the trailing partial block and the new
    blocks) and carried over to the returned store."""
    dims_old, meas_old = valid_rows_flat(store)
    dev = store.device
    dims_new = torch.from_numpy(np.ascontiguousarray(new.dims, np.int32)).to(dev)
    meas_new = torch.from_numpy(np.ascontiguousarray(new.measures, np.float32)).to(dev)
    touched = dirtied_block_ids(store, new.num_records)
    grown = rebuild_store(store, [dims_old, dims_new], [meas_old, meas_new], touched)
    store.notify_invalidated(touched)
    return grown
