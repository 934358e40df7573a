"""The port's FORWARD-OPTIMAL (paper §4.3, Algorithm 3) against the JAX
package's, on the CPU.

The faithful host DP must choose the reference's blocks at the reference's
cost (its loop order and strict ``<`` ties are the reference's), and the
scan DP must give the reference's ``opt_table`` bit for bit (every value a
min or one f32 add).  Theorem 3 is checked by brute force on tiny
instances, as ``tests/test_anyk.py`` does.  ``plan``, ``any_k`` and waves
with FORWARD-OPTIMAL occupants (device wave, host mirror, a sharded world
of one) return the reference's records.
"""
import dataclasses
import datetime
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_engine import _assert_query_equal

from repro.core import forward_optimal as jfo
from repro.core.cost_model import make_cost_model as jax_cost
from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.data import synthetic as jsyn
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store
from repro_torch.core import forward_optimal as fo
from repro_torch.core.cost_model import make_cost_model
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.data.block_store import Table, build_block_store


def _costs(kind: str, max_dist: int | None = None):
    mine, ref = make_cost_model(kind), jax_cost(kind)
    if max_dist is not None:
        mine = dataclasses.replace(mine, max_dist=max_dist)
        ref = dataclasses.replace(ref, max_dist=max_dist)
    return mine, ref


@pytest.mark.parametrize("kind,max_dist", [("hdd", None), ("ssd", None), ("hdd", 3)])
def test_rand_io_table_equals_reference(kind, max_dist):
    mine, ref = _costs(kind, max_dist)
    np.testing.assert_array_equal(mine.rand_io_table(), ref.rand_io_table())
    np.testing.assert_array_equal(mine.rand_io_table(7), ref.rand_io_table(7))
    assert mine.rand_io_table().dtype == np.float64


@pytest.mark.parametrize("seed", range(10))
def test_forward_optimal_brute_force(seed):
    """Theorem 3 on tiny instances: the DP's cost is the exhaustive
    search's, and both packages choose the same blocks at the same cost."""
    rng = np.random.default_rng(seed)
    lam, k = 8, 6
    cm, jcm = _costs("hdd", 3)
    comb = np.where(rng.random(lam) < 0.6, rng.random(lam) * 0.5, 0.0).astype(np.float32)
    s_blk = np.clip(np.rint(comb * 10), 0, k)
    sel, cost = fo.forward_optimal_faithful(torch.from_numpy(comb), k, 10, cm)
    assert (sel, cost) == jfo.forward_optimal_faithful(comb, k, 10, jcm)
    if not np.isfinite(cost):
        return
    best = np.inf
    for r in range(1, lam + 1):
        for subset in itertools.combinations(range(lam), r):
            if s_blk[list(subset)].sum() >= k:
                best = min(best, cm.io_time(list(subset)))
    assert cost == pytest.approx(best, rel=1e-6)
    scan = fo.forward_optimal_scan(torch.from_numpy(comb), k, 10, cm)
    assert float(scan.opt_cost) == pytest.approx(cost, rel=1e-4)


def _row(seed: int, lam: int, half: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.random(lam) ** 3).astype(np.float32)
    x[rng.random(lam) < 0.4] = 0.0
    if half:  # densities whose s_i lie at a half: both packages round to even
        x[::3] = (np.arange(x[::3].size) % 7 + 0.5).astype(np.float32) / 10
    return x


@pytest.mark.parametrize("seed,lam,k,kind,max_dist,half", [
    (0, 64, 40, "hdd", None, False), (1, 200, 150, "hdd", None, True),
    (2, 300, 90, "ssd", None, False), (3, 97, 200, "hdd", 5, True), (4, 1, 5, "ssd", None, False),
])
def test_scan_opt_table_bit_identical_to_reference(seed, lam, k, kind, max_dist, half):
    comb = _row(seed, lam, half)
    cm, jcm = _costs(kind, max_dist)
    mine = fo.forward_optimal_scan(torch.from_numpy(comb), k, 10, cm)
    ref = jfo.forward_optimal_scan(jnp.asarray(comb), k, 10, jcm)
    assert mine.opt_table.dtype == torch.float32 and mine.opt_table.shape == (k + 1,)
    np.testing.assert_array_equal(mine.opt_table.numpy(), np.asarray(ref.opt_table))
    assert float(mine.opt_cost) == float(ref.opt_cost)


@pytest.mark.parametrize("seed,lam,k,kind,half", [
    (5, 48, 60, "hdd", True), (6, 120, 80, "ssd", False), (7, 30, 10_000, "hdd", False),
    (8, 64, 50, "hdd", False),
])
def test_faithful_selection_and_cost_equal_reference(seed, lam, k, kind, half):
    comb = _row(seed, lam, half)
    cm, jcm = _costs(kind)
    sel, cost = fo.forward_optimal_faithful(comb, k, 10, cm)
    assert (sel, cost) == jfo.forward_optimal_faithful(comb, k, 10, jcm)
    if np.isfinite(cost) and not half:
        # the scan's Opt(k) is the DP's cost, where no s_i lies at a half
        # (the two round combined·rpb in f64 and in f32)
        scan = fo.forward_optimal_scan(torch.from_numpy(comb), k, 10, cm)
        assert float(scan.opt_cost) == pytest.approx(cost, rel=1e-4)


_CACHE: dict = {}


def _stores():
    """A clustered table of λ = 80 blocks: small enough for the O(λ·k·t)
    Python DP in every refill round of both packages."""
    if "s" not in _CACHE:
        t = jsyn.make_clustered_table(num_records=16_000, num_dims=4, density=0.15, seed=2)
        _CACHE["s"] = (jax_build_block_store(JaxTable(t.dims, t.measures, t.cards), 200),
                       build_block_store(Table(t.dims, t.measures, np.asarray(t.cards)), 200,
                                         device="cpu"))
    return _CACHE["s"]


QUERIES = [([(0, 1), (2, 1)], 120, "and"), ([(0, 1)], 60, "and"), ([(1, 1), (3, 1)], 90, "or")]


@pytest.mark.parametrize("kind", ["hdd", "ssd"])
def test_plan_and_any_k_equal_reference(kind):
    jstore, pstore = _stores()
    cm, jcm = _costs(kind)
    mine, ref = NeedleTailEngine(pstore, cost_model=cm, device="cpu"), JaxEngine(jstore, jcm)
    for preds, k, op in QUERIES:
        excl = np.arange(0, 80, 7)
        b, used = mine.plan(preds, k, op, "forward_optimal", exclude=excl)
        rb, rused = ref.plan(preds, k, op, "forward_optimal", exclude=excl)
        np.testing.assert_array_equal(b, rb)
        assert used == rused == "forward_optimal"
        _assert_query_equal(mine.any_k(preds, k, op, algo="forward_optimal"),
                            ref.any_k(preds, k, op, algo="forward_optimal"))


def _wave(query):
    return [query(p, k, op, "forward_optimal") for p, k, op in QUERIES] + \
        [query(p, k, op, None) for p, k, op in QUERIES[:2]]


@pytest.mark.parametrize("algo", ["auto", "forward_optimal"])
def test_waves_with_forward_optimal_occupants_equal_reference(algo):
    """FORWARD-OPTIMAL occupants plan on the host DP beside device-planned
    ones: both loops give the reference's results, rounds and counters."""
    jstore, pstore = _stores()
    ref = JaxEngine(jstore).any_k_batch(_wave(JaxQuery), algo=algo)
    for device in (True, False):
        mine = NeedleTailEngine(pstore, device="cpu").any_k_batch(
            _wave(BatchQuery), algo=algo, device=device)
        for m, r in zip(mine.results, ref.results):
            _assert_query_equal(m, r)
        assert (mine.rounds, mine.store_blocks_fetched, mine.cache_hits) == \
            (ref.rounds, ref.store_blocks_fetched, ref.cache_hits)


def test_forward_optimal_in_sharded_waves_of_a_world_of_one(tmp_path):
    from repro_torch.launch.mesh import make_host_mesh

    jstore, pstore = _stores()
    ref = JaxEngine(jstore).any_k_batch(_wave(JaxQuery), algo="auto")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        eng = NeedleTailEngine(pstore, device="cpu")
        eng.attach_mesh(make_host_mesh(device_type="cpu"))
        for device in (True, False):
            mine = eng.any_k_batch(_wave(BatchQuery), algo="auto", device=device)
            for m, r in zip(mine.results, ref.results):
                _assert_query_equal(m, r)
    finally:
        dist.destroy_process_group()
