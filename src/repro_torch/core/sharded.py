"""Distributed any-k over ``torch.distributed`` (the paper's §6 future work,
"distributed NeedleTail").

Counterpart of ``repro/core/sharded.py``.  The λ block range is split into P
contiguous shards, one per rank of the mesh's ``data`` group (each rank owns
``λ_local = ⌈λ/P⌉`` blocks; the last shards are zero-padded, and zero-density
blocks are never planned).  The reference runs each planner as one SPMD
``shard_map`` program; here every rank is a process of its own that runs the
same program on its own shard, and the collectives are ``torch.distributed``
calls on the group: the reference's tiled ``all_gather`` is a list-form
``dist.all_gather`` concatenated in rank order, its ``psum`` an
``all_reduce(SUM)``.  Every rank ends with the same outputs, so every rank
takes the same host decisions (refills, the ``auto`` cost comparison, memo
hits) and the next collective cannot deadlock.

* :func:`sharded_threshold` / :func:`sharded_threshold_batch` — exact
  distributed THRESHOLD: each rank sorts its slab (stable, on ``-x``), sends
  its top-C frontier (densities and global ids in one gather), and every
  rank sorts the ``C·P`` candidates and cuts the global prefix with
  :func:`repro_torch.kernels.window_scan.prefix_sum` (#6) in the reference's
  f32 order.  ``sufficient`` says whether C was large enough for exactness.
* :func:`sharded_two_prong` / :func:`sharded_two_prong_batch` — per-G-block
  group sums are gathered and the minimal group-aligned window is searched on
  every rank (:func:`repro_torch.core.two_prong.window_search`); ``group=1``
  is exact and equal to the single-device TWO-PRONG.
* :func:`sharded_threshold_bisect` / :func:`sharded_threshold_bisect_batch`
  — sort-free θ-bisection: per round each rank takes masked ``[Q, fanout]``
  statistics with :func:`repro_torch.kernels.theta_stats.bisect_round_batch`
  (#5 on the card, one launch a round with the previous round's bracket
  step) and one ``all_reduce`` merges them.
* :func:`sharded_ht_terms` — the global Horvitz-Thompson terms.

Each planner call runs one collective (a round of the bisection one per
round).  The planners take this rank's slab (what the reference's
``shard_map`` body sees); :func:`shard_density_maps` cuts it from a tensor
every rank holds whole.  :class:`DistributedAnyK` wraps them for
``run_batch(planner=...)``: its wave methods take the whole ``[Q, λ]`` wave
(replicated, as the engine's host mirror is) and shard it themselves, and
its :meth:`~DistributedAnyK.device_round_fn` is the device wave's round,
whose combine is #3 on the rank's slab, one launch a wave whatever its ops
(:func:`repro_torch.kernels.density_combine.density_combine_wave_sharded`)
and whose Predicate trees compile on the rank's slab of the index
(:meth:`~DistributedAnyK.predicate_row`).  ``forward_optimal`` queries plan
on the host DP in every loop, as in the reference.

Left for later slices: the peer-memory tier (``peer_group``,
``fetch_remote``), and an interconnect cost preset measured on H100s for
``remote_cost`` (the reference's default, ``"ici"``, is a TPU figure).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.two_prong import window_search
from repro_torch.device import resolve_device
from repro_torch.kernels.density_combine import density_combine_wave_sharded
from repro_torch.kernels.plan_wave import _first_true, apply_chosen, pack_plan
from repro_torch.kernels.theta_stats import bisect_carry, bisect_round_batch
from repro_torch.kernels.window_scan import prefix_sum

_PEER_SLICE = ("the peer-memory tier (storage/peer.py) arrives with the peer-tier "
               "slice, after tiered storage")


# --------------------------------------------------------------------------
# The shard group and its collectives.
# --------------------------------------------------------------------------

class ShardGroup(NamedTuple):
    """A rank's view of the λ-sharding: the process group, its size P and
    this rank's index in it (its shard)."""

    group: dist.ProcessGroup
    size: int
    index: int


def shard_group(mesh, axis: str = "data") -> ShardGroup:
    """The shard group of ``mesh``'s ``axis`` (a ``DeviceMesh``), or of a bare
    ``ProcessGroup``."""
    group = mesh if isinstance(mesh, dist.ProcessGroup) else mesh.get_group(axis)
    return ShardGroup(group, dist.get_world_size(group), dist.get_rank(group))


def _all_gather(t: torch.Tensor, sg: ShardGroup) -> list[torch.Tensor]:
    """``t`` of every rank, in rank order."""
    parts = [torch.empty_like(t) for _ in range(sg.size)]
    dist.all_gather(parts, t.contiguous(), group=sg.group)
    return parts


def _all_reduce_sum(t: torch.Tensor, sg: ShardGroup) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=sg.group)
    return t


def local_width(lam: int, num_shards: int) -> int:
    """``λ_local``: blocks per shard once λ is zero-padded to a multiple of P."""
    return -(-lam // num_shards)


def shard_density_maps(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous λ-range of ``x`` (the last axis is λ: the
    ``[rows, λ]`` index, a ``[Q, λ]`` wave or a ``[λ]`` row), zero-padded
    at the end so every shard is ``λ_local`` wide.  Contiguous."""
    sg = shard_group(mesh, axis)
    lam = x.shape[-1]
    w = local_width(lam, sg.size)
    lo = min(sg.index * w, lam)
    part = x[..., lo:min(lo + w, lam)]
    return torch.nn.functional.pad(part, (0, w - part.shape[-1])).contiguous()


# --------------------------------------------------------------------------
# THRESHOLD: gather the top-C frontiers, cut the global prefix.
# --------------------------------------------------------------------------

class ShardedThresholdResult(NamedTuple):
    block_ids: torch.Tensor  # [C*P] int32 global ids, density-desc; -1 past num_selected
    num_selected: torch.Tensor  # [] int32
    expected_records: torch.Tensor  # [] f32
    sufficient: torch.Tensor  # [] bool — True iff the cutoff is provably exact


class ShardedThresholdWave(NamedTuple):
    block_ids: torch.Tensor  # [Q, C*P] int32
    num_selected: torch.Tensor  # [Q] int32
    expected_records: torch.Tensor  # [Q] f32
    sufficient: torch.Tensor  # [Q] bool


def _local_threshold_body(
    local: torch.Tensor,  # [Q, λ_local] this rank's combined densities
    ks: torch.Tensor,  # [Q] f32
    records_per_block: int,
    candidates: int,
    sg: ShardGroup,
) -> ShardedThresholdWave:
    """The reference's ``_local_threshold_body`` for a whole wave: one
    gather of each rank's ``[Q, C]`` frontier (densities bit-cast to int32
    beside the global ids), then the same global cut on every rank."""
    nq, lam_local = local.shape
    top = torch.sort(-local, dim=1, stable=True).indices[:, :candidates]
    c = top.shape[1]  # < candidates when the slab is narrower
    top_d = torch.gather(local, 1, top)
    top_ids = (top + sg.index * lam_local).to(torch.int32)
    parts = _all_gather(torch.cat([top_d.view(torch.int32), top_ids], dim=1), sg)
    all_d = torch.cat([p[:, :c] for p in parts], dim=1).view(torch.float32)  # [Q, c·P]
    all_ids = torch.cat([p[:, c:] for p in parts], dim=1)
    g_order = torch.sort(-all_d, dim=1, stable=True).indices
    g_d = torch.gather(all_d, 1, g_order)
    g_ids = torch.gather(all_ids, 1, g_order)
    rpb = torch.tensor(float(records_per_block), dtype=torch.float32, device=local.device)
    cum = prefix_sum(g_d) * rpb
    reached = cum >= ks[:, None]
    any_hit = reached.any(dim=1)
    n_sel = torch.where(any_hit, _first_true(reached) + 1,
                        (g_d > 0).sum(dim=1)).to(torch.int32)
    pos = torch.arange(g_d.shape[1], device=local.device)[None, :]
    sel = pos < n_sel[:, None]
    ids = torch.where(sel, g_ids, -1)
    last = torch.gather(cum, 1, (n_sel.long() - 1).clamp(min=0)[:, None])[:, 0]
    exp = torch.where(n_sel > 0, last, 0.0)
    # exactness: a shard whose whole frontier was selected may hide blocks
    # denser than the cut.  The reference counts shards as gathered length
    # // C and drops the ids of shards past that count (its scatter drops
    # out-of-range updates); a frontier wider than the slab keeps that rule.
    counts = torch.zeros((nq, sg.size), dtype=torch.int64, device=local.device)
    counts.scatter_add_(1, g_ids.long() // lam_local, sel.long())
    num_shards = g_d.shape[1] // candidates
    sufficient = (counts[:, :num_shards] < candidates).all(dim=1)
    return ShardedThresholdWave(ids, n_sel, exp, sufficient)


def _ks(ks, n: int, device) -> torch.Tensor:
    """Record targets as an f32 ``[n]`` tensor (a scalar is broadcast)."""
    return torch.as_tensor(ks, dtype=torch.float32, device=device).expand(n).contiguous()


def sharded_threshold_batch(
    combined_local: torch.Tensor,  # [Q, λ_local] this rank's slab of the wave
    ks,  # [Q] f32 record targets
    records_per_block: int,
    mesh,
    axis: str = "data",
    candidates: int = 64,
) -> ShardedThresholdWave:
    """Distributed THRESHOLD for a whole wave in ONE collective: each rank's
    ``[Q, C]`` frontier is gathered (``Q·C·P·8`` bytes) and every rank cuts
    all Q global prefixes.  Row q equals :func:`sharded_threshold` on row q;
    ``block_ids[q, :num_selected[q]]`` equals the single-device THRESHOLD's
    selection whenever ``sufficient[q]``."""
    sg = shard_group(mesh, axis)
    ks = _ks(ks, combined_local.shape[0], combined_local.device)
    return _local_threshold_body(combined_local, ks, records_per_block, candidates, sg)


def sharded_threshold(
    combined_local: torch.Tensor,  # [λ_local] this rank's slab
    k: float,
    records_per_block: int,
    mesh,
    axis: str = "data",
    candidates: int = 64,
) -> ShardedThresholdResult:
    """Exact distributed THRESHOLD for one query (one round): a one-row
    :func:`sharded_threshold_batch`.  On an insufficient frontier re-plan with
    2C (:meth:`DistributedAnyK.threshold_plan`)."""
    r = sharded_threshold_batch(combined_local[None, :], [k], records_per_block, mesh,
                                axis, candidates)
    return ShardedThresholdResult(*(t[0] for t in r))


# --------------------------------------------------------------------------
# TWO-PRONG: gather G-block group sums, search the window on every rank.
# --------------------------------------------------------------------------

class ShardedTwoProngResult(NamedTuple):
    start_block: torch.Tensor  # [] int64 (group-aligned)
    end_block: torch.Tensor  # [] int64 exclusive
    expected_records: torch.Tensor  # [] f32


class ShardedTwoProngWave(NamedTuple):
    start_block: torch.Tensor  # [Q] int64
    end_block: torch.Tensor  # [Q] int64
    expected_records: torch.Tensor  # [Q] f32


def _local_two_prong_body(
    local: torch.Tensor,  # [Q, λ_local]
    ks: torch.Tensor,  # [Q] f32
    records_per_block: int,
    group: int,
    sg: ShardGroup,
) -> ShardedTwoProngWave:
    nq, lam_local = local.shape
    if lam_local % group:
        raise ValueError(f"λ_local {lam_local} is not a multiple of the group {group}")
    gsums = local.reshape(nq, lam_local // group, group).sum(dim=2) * records_per_block
    all_g = torch.cat(_all_gather(gsums, sg), dim=1)  # [Q, G_total]
    w = window_search(all_g, ks)
    return ShardedTwoProngWave(w.start * group, w.end * group, w.expected_records)


def sharded_two_prong_batch(
    combined_local: torch.Tensor,  # [Q, λ_local]
    ks,
    records_per_block: int,
    mesh,
    axis: str = "data",
    group: int = 1,
) -> ShardedTwoProngWave:
    """Distributed TWO-PRONG for a whole wave in ONE collective (``Q·(λ/G)·4``
    bytes).  ``group=1`` is exact: each window equals
    :func:`repro_torch.core.two_prong.two_prong_select_batch` on the same row
    (an end may fall in the λ padding only where no window reaches k; callers
    clamp it to λ).  ``group>1`` gives group-aligned windows up to G blocks
    wider per side; the group sums then add in another order than the
    reference's, so a window may differ from its at f32 boundary cases."""
    sg = shard_group(mesh, axis)
    ks = _ks(ks, combined_local.shape[0], combined_local.device)
    return _local_two_prong_body(combined_local, ks, records_per_block, group, sg)


def sharded_two_prong(
    combined_local: torch.Tensor,  # [λ_local]
    k: float,
    records_per_block: int,
    mesh,
    axis: str = "data",
    group: int = 64,
) -> ShardedTwoProngResult:
    """Hierarchical distributed TWO-PRONG for one query: a one-row
    :func:`sharded_two_prong_batch` (G = 64 by default, as the reference)."""
    r = sharded_two_prong_batch(combined_local[None, :], [k], records_per_block, mesh,
                                axis, group)
    return ShardedTwoProngResult(*(t[0] for t in r))


def sharded_ht_terms(
    tau_over_pi_local: torch.Tensor,  # [B_local] per-block τ_i/π_i on this shard
    n_over_pi_local: torch.Tensor,
    mesh,
    axis: str = "data",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global HT numerator and denominator (Eq. 1/5 across shards): the
    local sums, all-reduced."""
    terms = torch.stack([tau_over_pi_local.sum(), n_over_pi_local.sum()])
    terms = _all_reduce_sum(terms, shard_group(mesh, axis))
    return terms[0], terms[1]


# --------------------------------------------------------------------------
# θ-bisection: per-rank statistics, one all-reduce per round.
# --------------------------------------------------------------------------

class ShardedBisectResult(NamedTuple):
    theta: torch.Tensor  # [] f32 — largest θ with ≥ k expected records above it
    num_selected: torch.Tensor  # [] int32 blocks with density ≥ θ
    expected_records: torch.Tensor  # [] f32


class ShardedBisectWave(NamedTuple):
    theta: torch.Tensor  # [Q] f32
    num_selected: torch.Tensor  # [Q] int32
    expected_records: torch.Tensor  # [Q] f32


def sharded_threshold_bisect_batch(
    combined_local: torch.Tensor,  # [Q, λ_local]
    ks,
    records_per_block: int,
    mesh,
    axis: str = "data",
    rounds: int = 3,
    fanout: int = 16,
) -> ShardedBisectWave:
    """Batched distributed θ-bisection: every round each rank takes masked
    ``[Q, fanout]`` (count, Σdensity) statistics of its slab and one
    ``all_reduce`` of ``Q·2·fanout`` floats merges them.  A round is one
    call of :func:`repro_torch.kernels.theta_stats.bisect_round_batch`
    (#5 on CUDA tensors: one launch that applies the previous round's
    bracket step and takes this round's statistics into the buffer the
    all-reduce takes; its plain version on CPU ones), and one more call
    applies the last step: ``rounds + 1`` launches and ``rounds``
    collectives.  Counts are exact; the sums add in another order than the
    reference's, so θ may differ from its where a threshold's record mass
    lies within f32 rounding of k."""
    sg = shard_group(mesh, axis)
    nq = combined_local.shape[0]
    dev = combined_local.device
    ks = _ks(ks, nq, dev)
    rounds = max(int(rounds), 0)
    carry = bisect_carry(nq, fanout, dev)
    for r in range(rounds):
        carry = bisect_round_batch(combined_local, ks, records_per_block, carry, first=r == 0)
        dist.all_reduce(carry.stats, op=dist.ReduceOp.SUM, group=sg.group)
    carry = bisect_round_batch(combined_local, ks, records_per_block, carry, first=rounds == 0,
                               stats=False)
    return ShardedBisectWave(theta=carry.lo, num_selected=carry.n_sel,
                             expected_records=carry.exp)


def sharded_threshold_bisect(
    combined_local: torch.Tensor,  # [λ_local]
    k: float,
    records_per_block: int,
    mesh,
    axis: str = "data",
    rounds: int = 3,
    fanout: int = 16,
) -> ShardedBisectResult:
    """Sort-free distributed THRESHOLD for one query: a one-row
    :func:`sharded_threshold_bisect_batch` (``rounds·2·fanout·4`` bytes on
    the wire instead of the gather planner's ``C·P·8``)."""
    r = sharded_threshold_bisect_batch(combined_local[None, :], [k], records_per_block,
                                       mesh, axis, rounds, fanout)
    return ShardedBisectResult(*(t[0] for t in r))


# --------------------------------------------------------------------------
# The production wrapper.
# --------------------------------------------------------------------------

def _sharded_device_round_fn(sg: ShardGroup, records_per_block: int, lam: int, group: int):
    """The device wave's round on a λ-sharded wave (the reference's
    ``_sharded_device_round_fn``).  ``combined0`` is this rank's ``[Qb,
    λ_local]`` slab; the exclusion mask, the previous round's prefix and
    window and the packed plan stay ``[Qb, λ]`` and equal on every rank.
    One round replays the host's choices onto the mask, masks the slab,
    runs the full-local-sort THRESHOLD (C = λ_local: exact, so no refill and
    no flag to read) and the wave TWO-PRONG, and scatters the gathered
    global ids into the ``[Qb, λ]`` THRESHOLD mask."""
    lam_local = local_width(lam, sg.size)
    lo = min(sg.index * lam_local, lam)
    hi = min(lo + lam_local, lam)

    def round_fn(combined0, excl, th_prev, tp_prev, chosen_prev, needs):
        excl = apply_chosen(excl, th_prev, tp_prev, chosen_prev)
        excl_local = torch.nn.functional.pad(excl[:, lo:hi], (0, lam_local - (hi - lo)))
        masked = torch.where(excl_local, 0.0, combined0)
        th = _local_threshold_body(masked, needs, records_per_block, lam_local, sg)
        qa = combined0.shape[0]
        # selected ids are unique per row and -1 past n_sel: a scatter-add
        # of the selection cannot collide with a real selection of block 0
        hits = torch.zeros((qa, lam_local * sg.size), dtype=torch.int32, device=excl.device)
        sel = (th.block_ids >= 0).to(torch.int32)
        hits.scatter_add_(1, th.block_ids.clamp(min=0).long(), sel)
        th_mask = (hits > 0)[:, :lam]
        tp = _local_two_prong_body(masked, needs, records_per_block, group, sg)
        s = tp.start_block.to(torch.int32)
        e = tp.end_block.clamp(max=lam).to(torch.int32)  # λ padding is never planned
        packed = pack_plan(th_mask, th.num_selected, s, e)
        return packed, excl, th_mask, torch.stack([s, e], dim=1)

    return round_fn


class DistributedAnyK:
    """Production wrapper over the sharded planners.

    Geometric frontier refill on an insufficient THRESHOLD, the planner
    choice by shard count (sort-gather up to ``bisect_above`` shards,
    θ-bisection beyond), wave planning for ``run_batch(planner=...)`` and
    fetches through the engine-lifetime block cache.  Every rank of the
    mesh's ``axis`` group builds one over the same store and calls it with
    the same arguments (SPMD); results are equal on every rank.

    Parameters
    ----------
    mesh : torch.distributed.device_mesh.DeviceMesh | torch.distributed.ProcessGroup
        The mesh whose ``axis`` group shards λ (:func:`repro_torch.launch.
        mesh.make_host_mesh`), or the group itself.
    axis : str
        Mesh dimension that shards λ.
    records_per_block : int
        Block capacity R of the store being planned for.
    candidates : int
        Initial per-shard THRESHOLD frontier C (doubled on refill).
    max_refills : int
        Scalar-path cap on frontier refills (the wave path grows C until
        every query is provably exact or C reaches λ/P, which is exact).
    bisect_above : int
        Shard count beyond which the scalar path uses θ-bisection.
    block_cache : repro_torch.core.block_cache.BlockLRUCache | None
        The engine's cache (``NeedleTailEngine.attach_mesh`` passes it), so
        scalar, batched and sharded fetches share one cache.
    two_prong_group : int
        G of the wave TWO-PRONG; the default 1 is exact.
    remote_cost : repro_torch.core.cost_model.CostModel | None
        Prices :meth:`fetch_plan` (``last_fetch_io_s``; residency-aware
        when the cache is a tier stack).  ``None`` leaves fetches unpriced:
        the reference's default, the ``"ici"`` preset, is a TPU
        interconnect figure, and a preset measured on H100s arrives with
        the multi-GPU slice.
    peer_group : None
        The peer-memory tier; raises until the peer-tier slice lands.
    device : str | torch.device | None
        Where the planners run; defaults to the mesh's device type
        (``"cuda"`` for a bare group).
    """

    def __init__(self, mesh, axis: str = "data", records_per_block: int = 8192,
                 candidates: int = 16, max_refills: int = 4, bisect_above: int = 512,
                 block_cache=None, two_prong_group: int = 1, remote_cost=None,
                 peer_group=None, device=None):
        if peer_group is not None:
            raise NotImplementedError(_PEER_SLICE)
        self.mesh = mesh
        self.axis = axis
        self.sg = shard_group(mesh, axis)
        self.num_shards = self.sg.size
        self.device = resolve_device(device or getattr(mesh, "device_type", "cuda"))
        self.rpb = records_per_block
        self.candidates = candidates
        self.max_refills = max_refills
        self.use_bisect = self.num_shards > bisect_above
        self.block_cache = block_cache
        self.two_prong_group = two_prong_group
        self.remote_cost = remote_cost
        self.last_fetch_io_s = 0.0
        self._index = (None, None)  # (whole index, this rank's slab of it)

    # ------------------------------------------------------------- wave shard
    def _device_wave(self, combined) -> tuple[torch.Tensor, int]:
        """This rank's λ-shard of a whole ``[Q, λ]`` (or ``[λ]``) wave, f32
        on the planner's device, and λ."""
        combined = torch.as_tensor(combined, dtype=torch.float32).to(self.device)
        return shard_density_maps(combined, self.sg.group), combined.shape[-1]

    def local_width(self, lam: int) -> int:
        return local_width(lam, self.num_shards)

    def local_index(self, densities: torch.Tensor) -> torch.Tensor:
        """This rank's ``[rows, λ_local]`` slab of the ``[rows, λ]`` index,
        cut once per index."""
        if self._index[0] is not densities:
            self._index = (densities, shard_density_maps(densities, self.sg.group))
        return self._index[1]

    def combine_wave(self, densities: torch.Tensor, row_matrix: np.ndarray,
                     ops) -> torch.Tensor:
        """``[Q, λ_local]``: the wave's ⊕-combine on this rank's slab of the
        index, each row under its own op (``ops[q]``): one launch of #3
        (host-checked row ids, as ``combine_densities_wave``)."""
        rm = torch.from_numpy(np.asarray(row_matrix, np.int32))
        return density_combine_wave_sharded(self.local_index(densities), rm, ops, self.mesh,
                                            self.axis)

    def predicate_row(self, index, pred) -> torch.Tensor:
        """``[λ_local]``: the ``Predicate`` tree ``pred`` compiled on this
        rank's slab of ``index`` (elementwise in λ, so equal to those
        columns of the whole row), its padding columns past λ set to +0.0
        (a ``Not`` would make them dense and plannable)."""
        local = dataclasses.replace(index, densities=self.local_index(index.densities))
        row = pred.density(local)
        valid = index.num_blocks - self.sg.index * row.shape[0]
        row[max(valid, 0):] = 0.0
        return row

    # ------------------------------------------------------------ scalar plans
    @staticmethod
    def plan_block_ids(plan) -> np.ndarray:
        """A scalar plan's block ids on the host, ascending (§4.1 order)."""
        if isinstance(plan, ShardedThresholdResult):
            ids = plan.block_ids[: int(plan.num_selected)].cpu().numpy()
            return np.sort(ids.astype(np.int64))
        if isinstance(plan, ShardedTwoProngResult):
            return np.arange(int(plan.start_block), int(plan.end_block), dtype=np.int64)
        raise TypeError(f"cannot materialize block ids from {type(plan).__name__}")

    def fetch_remote(self, block_ids, requester: int | None = 0) -> dict:
        raise NotImplementedError(_PEER_SLICE)

    def fetch_plan(self, store, plan):
        """``(block_ids, dims, measures, valid)`` of a scalar plan, read
        through the shared block cache when one is attached (byte-identical
        to ``store.fetch``).  With a ``remote_cost`` model,
        ``last_fetch_io_s`` is its price of the plan's ids, taken before
        the read; without one it stays 0.0."""
        ids = self.plan_block_ids(plan)
        if self.remote_cost is not None:
            # priced BEFORE the read, residency-aware on a tier stack: only
            # blocks no tier holds cross at the remote price
            eff = getattr(self.block_cache, "effective_io_time", None)
            self.last_fetch_io_s = (eff(ids, backing=self.remote_cost) if eff is not None
                                    else self.remote_cost.io_time(ids))
        if self.block_cache is not None:
            return (ids, *self.block_cache.get_many(store, ids))
        return (ids, *store.fetch(ids))

    def threshold_plan(self, combined, k: float):
        """Scalar THRESHOLD over a whole ``[λ]`` row: θ-bisection beyond
        ``bisect_above`` shards, else the sort-gather planner with the
        frontier doubled on an insufficient result, up to ``max_refills``
        times."""
        local, _ = self._device_wave(combined)
        if self.use_bisect:
            return sharded_threshold_bisect(local, k, self.rpb, self.sg.group)
        c = self.candidates
        for _ in range(self.max_refills):
            r = sharded_threshold(local, k, self.rpb, self.sg.group, candidates=c)
            if bool(r.sufficient):
                return r
            c *= 2  # geometric backoff: some shard's frontier was exhausted
        return r

    def two_prong_plan(self, combined, k: float, group: int = 64):
        """Scalar TWO-PRONG over a whole ``[λ]`` row at G-block granularity."""
        local, _ = self._device_wave(combined)
        return sharded_two_prong(local, k, self.rpb, self.sg.group, group=group)

    # ----------------------------------------------------------- wave planning
    def threshold_plan_wave(self, combined, needs) -> list[np.ndarray]:
        """THRESHOLD-plan a whole ``[Q, λ]`` wave (exclusions zeroed in), one
        collective per refill.  Returns each query's ascending block ids,
        the single-device THRESHOLD's selection as a set: the frontier
        doubles until every query is provably exact, and C = λ/P (the full
        local sort) is exact by construction."""
        local, _ = self._device_wave(combined)
        qa, lam_local = local.shape
        c = min(self.candidates, lam_local)
        while True:
            r = sharded_threshold_batch(local, needs, self.rpb, self.sg.group, candidates=c)
            # a full local sort is exact even where the flag is pessimistic
            # (a shard whose whole range is selected saturates it)
            if c == lam_local or bool(r.sufficient.all()):
                break
            c = min(c * 2, lam_local)
        ids, n_sel = r.block_ids.cpu().numpy(), r.num_selected.cpu().numpy()
        return [np.sort(ids[q, :int(n_sel[q])].astype(np.int64)) for q in range(qa)]

    def two_prong_plan_wave(self, combined, needs) -> list[tuple[int, int]]:
        """TWO-PRONG-plan a whole ``[Q, λ]`` wave in one collective: each
        query's ``(start, end)``, the end clamped to λ (the padding blocks
        carry zero density).  With ``two_prong_group=1`` each window equals
        the single-device TWO-PRONG's."""
        local, lam = self._device_wave(combined)
        r = sharded_two_prong_batch(local, needs, self.rpb, self.sg.group,
                                    group=self.two_prong_group)
        starts, ends = r.start_block.cpu().numpy(), r.end_block.cpu().numpy()
        return [(int(s), min(int(e), lam)) for s, e in zip(starts, ends)]

    def device_round_fn(self, lam: int, records_per_block: int | None = None):
        """The device wave's round for a store of λ blocks when this planner
        is attached (``multi_query.DeviceWave``): each round's plan is one
        collective per planner on the rank's slab, feeding the device block
        cut; one packed device→host copy per round.  Equal to the host
        loop's plans for ``two_prong_group == 1``."""
        return _sharded_device_round_fn(self.sg, records_per_block or self.rpb, lam,
                                        self.two_prong_group)

    def bisect_stats_wave(self, combined, needs, **kw) -> ShardedBisectWave:
        """θ-bisection statistics of a whole ``[Q, λ]`` wave (no ids);
        ``rounds`` / ``fanout`` go to :func:`sharded_threshold_bisect_batch`."""
        local, _ = self._device_wave(combined)
        return sharded_threshold_bisect_batch(local, needs, self.rpb, self.sg.group, **kw)

    def any_k_batch(self, engine, queries, algo: str = "auto", device: bool = True):
        """Q any-k queries with sharded planning through ``engine``: the
        device wave (``device=True``, the port's default) or the host-mirror
        loop, each round planned by one collective per planner.  Per-query
        results equal ``engine.any_k_batch`` without a mesh."""
        from repro_torch.core.multi_query import run_batch

        return run_batch(engine, queries, algo=algo, plan_on_host=not device, planner=self)
