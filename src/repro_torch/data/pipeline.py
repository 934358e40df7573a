"""NeedleTail-driven training data pipeline (counterpart of
``repro/data/pipeline.py``).

The training corpus is an attribute-tagged token block store; a filter
predicate ("domain=code AND quality=hi") is served by the any-k engine,
which picks the densest unconsumed blocks to fill each batch: the paper's
any-k browsing with k = sequences per batch and a per-epoch ``consumed``
exclusion set (the engine's re-execution mechanism).

Each refill runs on the store's device: the filter's ⊕-combine with the
consumed blocks excluded in the same launch (``density_combine``, #1, on
the card), the THRESHOLD plan (its prefix sums ``prefix_sum``, #6), one host
copy of the chosen block ids, the read of those blocks (``block_gather``,
#7) and the predicate mask, whose ``nonzero`` keeps numpy's row-major
order.  The pipeline state (consumed mask, round, rng counter) and the
record buffer stay on the host, exactly as the reference keeps them, so a
restart from a checkpoint is sample-exact.  Batches are gathered from the
tokens on the device.

``hedged_fetch`` models straggler mitigation: duplicate reads for the
slowest predicted blocks, the first arrival kept.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.density_map import AND
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.threshold import threshold_select
from repro_torch.data.block_store import BlockStore, Table, build_block_store
from repro_torch.device import resolve_device

DOMAINS = ["web", "code", "books", "academic", "dialog", "news"]
QUALITY = ["lo", "mid", "hi"]
LANGS = ["en", "zh", "de", "fr"]
ATTR_NAMES = {"domain": 0, "quality": 1, "lang": 2, "len_bucket": 3}
ATTR_VALUES = {
    "domain": DOMAINS, "quality": QUALITY, "lang": LANGS,
    "len_bucket": ["short", "med", "long"],
}


def make_token_corpus(
    num_seqs: int = 4096,
    seq_len: int = 128,
    vocab: int = 512,
    records_per_block: int = 32,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[BlockStore, torch.Tensor]:
    """Synthetic tagged corpus: clustered attribute layout (documents of the
    same domain/quality arrive together, the locality the paper exploits).
    The draws are the reference's, in its order, so the table and the tokens
    are the same bytes; the store and the ``[num_seqs, seq_len]`` int32
    tokens live on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    # run length scales with corpus size so every value appears in tiny corpora
    def clustered(card, mean_run=max(4, num_seqs // 64)):
        out = np.empty(num_seqs, np.int32)
        i = 0
        while i < num_seqs:
            run = 1 + int(rng.geometric(1.0 / mean_run))
            out[i : i + run] = rng.integers(0, card)
            i += run
        return out

    dims = np.stack(
        [clustered(len(DOMAINS)), clustered(len(QUALITY)), clustered(len(LANGS)),
         clustered(3)], axis=1
    )
    measures = rng.normal(100.0, 25.0, size=(num_seqs, 1)).astype(np.float32)
    table = Table(dims=dims, measures=measures,
                  cards=np.asarray([len(DOMAINS), len(QUALITY), len(LANGS), 3]))
    store = build_block_store(table, records_per_block, device=dev)
    tokens = rng.integers(0, vocab, size=(num_seqs, seq_len), dtype=np.int32)
    return store, torch.from_numpy(tokens).to(dev)


def parse_filter(expr: str) -> list[tuple[int, int]]:
    """'domain=code,quality=hi' -> [(attr_id, value_id), ...]"""
    preds = []
    if not expr:
        return preds
    for part in expr.split(","):
        k, v = part.strip().split("=")
        attr = ATTR_NAMES[k.strip()]
        preds.append((attr, ATTR_VALUES[k.strip()].index(v.strip())))
    return preds


@dataclasses.dataclass
class PipelineState:
    consumed: np.ndarray  # [lam] bool
    round: int
    rng_counter: int

    def to_arrays(self) -> dict:
        return {
            "consumed": self.consumed.astype(np.uint8),
            "round": np.asarray(self.round),
            "rng_counter": np.asarray(self.rng_counter),
        }

    @classmethod
    def from_arrays(cls, d) -> "PipelineState":
        return cls(
            consumed=np.asarray(d["consumed"]).astype(bool),
            round=int(d["round"]),
            rng_counter=int(d["rng_counter"]),
        )


class FilteredBatchStream:
    """Iterator of ``{tokens, labels, record_ids}`` batches matching a
    predicate filter: ``tokens`` and ``labels`` ``[batch, seq_len − 1]``
    int32 on the tokens' device, ``record_ids`` a host int64 array."""

    def __init__(
        self,
        store: BlockStore,
        tokens: torch.Tensor,
        predicates: Sequence[tuple[int, int]],
        batch_size: int,
        algo: str = "auto",
        seed: int = 0,
        state: PipelineState | None = None,
    ):
        self.engine = NeedleTailEngine(store, device=store.device)
        self.store = store
        self.tokens = tokens
        self.preds = list(predicates)
        self.batch = batch_size
        self.algo = algo
        self.seed = seed
        self.state = state or PipelineState(
            consumed=np.zeros(store.num_blocks, bool), round=0, rng_counter=0
        )
        self._buffer: list[int] = []  # record ids ready to emit

    def _combined(self, exclude: np.ndarray) -> torch.Tensor:
        """The filter's ``[λ]`` density with ``exclude`` at +0.0 on the
        store's device; for the empty filter all ones, the exclusion set on
        the host, as the reference does."""
        if self.preds:
            return self.engine.combined_density(self.preds, exclude=exclude)
        ones = np.ones(self.store.num_blocks, np.float32)
        ones[exclude] = 0.0
        return torch.from_numpy(ones).to(self.store.device)

    def _refill(self):
        combined = self._combined(np.flatnonzero(self.state.consumed))
        if not bool(torch.any(combined > 0)):  # epoch boundary: reset exclusion set
            self.state.consumed[:] = False
            self.state.round += 1
            combined = self._combined(np.zeros(0, np.int64))
        r = threshold_select(combined, float(self.batch), self.store.records_per_block)
        n = int(r.num_selected)
        blocks = np.sort(r.block_ids[:n].cpu().numpy().astype(np.int64))
        if blocks.size == 0:
            return
        bd, _, bv = self.store.fetch(blocks)
        mask = (self.store.predicate_mask(bd, self.preds, AND) & bv) if self.preds else bv
        bi, ri = torch.nonzero(mask).cpu().numpy().T
        rec_ids = blocks[bi] * self.store.records_per_block + ri
        # deterministic shuffle keyed by (seed, rng_counter)
        rng = np.random.default_rng((self.seed, self.state.rng_counter))
        self.state.rng_counter += 1
        order = rng.permutation(rec_ids.size)
        self._buffer.extend(rec_ids[order].tolist())
        self.state.consumed[blocks] = True

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        guard = 0
        while len(self._buffer) < self.batch:
            before = len(self._buffer)
            self._refill()
            guard += 1
            if len(self._buffer) == before and guard > 4:
                raise StopIteration("filter matches no records")
        ids = np.asarray([self._buffer.pop() for _ in range(self.batch)], dtype=np.int64)
        toks = self.tokens[torch.from_numpy(ids).to(self.tokens.device)]
        return {"tokens": toks[:, :-1].to(torch.int32).contiguous(),
                "labels": toks[:, 1:].to(torch.int32).contiguous(),
                "record_ids": ids}


def hedged_fetch(
    store: BlockStore,
    blocks: np.ndarray,
    latency_fn,
    hedge_quantile: float = 0.9,
) -> tuple[np.ndarray, float]:
    """Straggler-mitigated fetch: issue duplicates for the slowest-predicted
    tail of the plan; completion time = max over blocks of min(primary, hedge).

    ``latency_fn(block_ids, attempt)`` returns per-block latencies; the second
    attempt models re-issue to a replica.  Returns (blocks, modeled completion
    time).  Mechanism-level simulation, in numpy as in the reference."""
    lat = np.asarray(latency_fn(blocks, 0), dtype=np.float64)
    cut = np.quantile(lat, hedge_quantile) if blocks.size else 0.0
    slow = lat >= cut
    lat2 = np.where(slow, np.asarray(latency_fn(blocks, 1), np.float64), np.inf)
    eff = np.minimum(lat, lat2)
    return blocks, float(eff.max() if blocks.size else 0.0)
