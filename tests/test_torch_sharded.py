"""The port's sharded any-k wave against the JAX package's, at P = 4 on the CPU.

The port runs as four ranks (``python -c`` processes under a time limit,
gloo over a ``file://`` rendezvous under ``tmp_path``), each importing no
JAX; the reference's sharded planners run at the same P in one process with
four forced host devices.  Inputs are made with numpy from seeds and written
to an ``.npz`` both read; each side writes its outputs to ``.npz`` files
that the tests compare:

* #3 on every rank's slab, bit for bit, against the reference's
  ``density_combine_batch_sharded`` (its jnp fold and its Pallas kernel in
  interpret mode);
* the scalar and wave planners: ids, ``num_selected``, ``sufficient``,
  windows and θ exact, sums within ``rtol=1e-5``;
* ``attach_mesh`` + ``any_k_batch`` (device wave and host mirror) on every
  rank, byte for byte, against the reference's ``any_k_batch`` in this
  process; the reference's edge cases; the warm replan's counters; group > 1
  windows and the memo; the skewed frontier refill; ``fetch_plan`` on the
  engine's cache.

A world of one runs in this process.
"""
import datetime
import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from repro.core.engine import NeedleTailEngine as JaxEngine
from repro.core.multi_query import BatchQuery as JaxQuery
from repro.data import synthetic as jsyn
from repro.data.block_store import Table as JaxTable
from repro.data.block_store import build_block_store as jax_build_block_store

REPO = pathlib.Path(__file__).resolve().parent.parent
P = 4
ALGOS = ("threshold", "two_prong", "auto")
RTOL = 1e-5
RANK_TIMEOUT_S = 180  # a hung collective fails the launch, not the suite
# planner inputs: a [Q, λ] wave of sparse densities, its needs, R = 10
WAVE_Q, WAVE_LAM, WAVE_RPB = 8, 4 * 128, 10
THRESHOLD_CANDIDATES = (4, 32, 128, 256)

# query sets: (table, [(predicates, k, op), ...]); the reference's layouts
# and edge cases (tests/test_sharded_batch.py), here at P = 4
CASES = {
    "clustered": ("clustered", [([(0, 1), (2, 1)], 300, "and"), ([(0, 1)], 50, "and"),
                                ([(1, 1), (3, 1)], 200, "or"), ([(2, 0)], 10, "and")]),
    "uniform": ("uniform", [([(0, 0)], 40, "and"), ([(1, 0), (2, 2)], 80, "and"),
                            ([(0, 0), (1, 1)], 500, "or")]),
    "skewed": ("skewed", [([(0, 1)], 400, "and"), ([(0, 1), (1, 1)], 200, "and"),
                          ([(0, 1), (1, 0)], 100, "or")]),
    "q1": ("disjoint", [([(0, 1)], 120, "and")]),
    "q3_not_divisible": ("disjoint", [([(0, 1)], 150, "and"), ([(1, 1)], 150, "and"),
                                      ([(2, 1)], 90, "and")]),
    "q5_not_divisible": ("disjoint", [([(0, 1)], 60, "and"), ([(1, 1)], 60, "and"),
                                      ([(0, 1), (2, 1)], 90, "and"),
                                      ([(1, 1), (2, 0)], 90, "and"),
                                      ([(0, 1), (1, 1)], 10, "and")]),
    "disjoint_pair": ("disjoint", [([(0, 1)], 150, "and"), ([(1, 1)], 150, "and")]),
}
RPB = {"clustered": 100, "uniform": 64, "skewed": 50, "disjoint": 100}
# Predicate trees on "uniform" (λ = 235, not a multiple of P), as nested
# lists for _tree: each Not makes the zero-padded columns of the last shard
# dense unless they are zeroed
TREES = ("uniform", [(["Not", ["Eq", 0, 0]], 500),
                     (["And", ["Not", ["In", 1, [0, 1]]], ["Eq", 2, 2]], 90),
                     (["Or", ["Eq", 0, 1], ["Not", ["In", 2, [0, 1]]]], 700)])


def _tree(m, spec):
    """The tree ``spec`` describes, built from predicate module ``m``."""
    op, *args = spec
    if op in ("And", "Or"):
        return getattr(m, op)(tuple(_tree(m, a) for a in args))
    if op == "Not":
        return m.Not(_tree(m, args[0]))
    return m.In(args[0], tuple(args[1])) if op == "In" else m.Eq(*args)
WARM = "clustered"  # the warm replan's and the group > 1 case's table


def _tables() -> dict:
    """``{name: (dims, measures, cards)}``, numpy, from seeds."""
    t = jsyn.make_clustered_table(num_records=16_000, num_dims=4, density=0.15, seed=2)
    out = {"clustered": (np.asarray(t.dims), np.asarray(t.measures), np.asarray(t.cards))}
    rng = np.random.default_rng(7)  # λ = 235: not a multiple of P
    out["uniform"] = (rng.integers(0, 3, (15_000, 3)).astype(np.int32),
                      rng.normal(size=(15_000, 2)).astype(np.float32), np.asarray([3, 3, 3]))
    rng = np.random.default_rng(3)  # density piled at one end
    n = 8_000
    a0 = np.zeros(n, np.int32)
    a0[:500] = 1
    a1 = rng.integers(0, 2, n).astype(np.int32)
    out["skewed"] = (np.stack([a0, a1], axis=1), rng.normal(size=(n, 1)).astype(np.float32),
                     np.asarray([2, 2]))
    # 64 blocks of 100: attr 0 matches only blocks 0..7 (shard 0 at P = 4),
    # attr 1 only blocks 56..63 (shard 3), attr 2 every other block
    n = 64 * 100
    a0 = np.zeros(n, np.int32)
    a0[:800] = 1
    a1 = np.zeros(n, np.int32)
    a1[5600:] = 1
    a2 = (np.arange(n) // 100 % 2).astype(np.int32)
    rng = np.random.default_rng(0)
    out["disjoint"] = (np.stack([a0, a1, a2], axis=1),
                       rng.normal(size=(n, 1)).astype(np.float32), np.asarray([2, 2, 2]))
    return out


def _inputs() -> dict:
    """Everything both sides read, as numpy arrays."""
    arr = {}
    for name, (d, m, c) in _tables().items():
        arr[f"table/{name}/dims"], arr[f"table/{name}/measures"] = d, m
        arr[f"table/{name}/cards"] = c
    rng = np.random.default_rng(11)
    for lam in (4 * 96, 235):  # #3 on slabs of a λ that P divides, and of one it does not
        arr[f"combine/{lam}/dens"] = rng.random((9, lam)).astype(np.float32) ** 2
    arr["combine/rm"] = np.asarray([[0, 3, 5], [2, -1, -1], [8, 1, -1], [4, 4, 7]], np.int32)
    wave = np.where(rng.random((WAVE_Q, WAVE_LAM)) < 0.4,
                    rng.random((WAVE_Q, WAVE_LAM)), 0.0).astype(np.float32)
    wave[1, :] = 0.0  # a row with nothing: plans run dry
    wave[2, 200:] = 0.0  # density on shards 0 and 1 only
    wave[3, 300:340] = 1.0  # a tie group of full blocks
    arr["wave"] = wave
    arr["wave_ks"] = np.asarray([5.0, 50.0, 300.0, 900.0, 2000.0, 1e9, 10.0, 120.0],
                                np.float32)
    skew = np.zeros(4 * 128, np.float32)  # all density on shard 0's first 100 blocks
    skew[:100] = rng.random(100).astype(np.float32)
    arr["skew"] = skew
    arr["ht_tau"] = rng.random(WAVE_LAM).astype(np.float32)
    arr["ht_n"] = rng.random(WAVE_LAM).astype(np.float32)
    return arr


# ---------------------------------------------------------------------------
# The port: four ranks, no JAX.
# ---------------------------------------------------------------------------

RANK_CODE = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.core import sharded as S
from repro_torch.core.cost_model import make_cost_model
from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.multi_query import BatchQuery
from repro_torch.data.block_store import Table, build_block_store
from repro_torch.kernels.density_combine import density_combine_batch_sharded
from repro_torch.launch.mesh import make_host_mesh

CASES, RPB, ALGOS, WARM, CANDS, TREES, TREE_BUILDER = json.loads(sys.argv[5])
mesh = make_host_mesh(device_type="cpu")
inp = dict(np.load(f"{io}/inputs.npz"))
out = {}
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
local = lambda x: S.shard_density_maps(T(x), mesh)

# -- #3 on this rank's slab
rm = T(inp["combine/rm"])
for key in [k for k in inp if k.startswith("combine/") and k.endswith("/dens")]:
    for op in ("and", "or"):
        out[f"{key[:-5]}/{op}"] = density_combine_batch_sharded(local(inp[key]), rm, mesh, op).numpy()

# -- the planners, on this rank's slab of the wave
wave, ks = inp["wave"], inp["wave_ks"]
wl = local(wave)
for c in CANDS:
    r = S.sharded_threshold_batch(wl, ks, 10, mesh, candidates=c)
    for f, v in r._asdict().items():
        out[f"th_batch/{c}/{f}"] = v.numpy()
    r = S.sharded_threshold(wl[2], float(ks[2]), 10, mesh, candidates=c)
    for f, v in r._asdict().items():
        out[f"th/{c}/{f}"] = v.numpy()
for g in (1, 4, 16):
    r = S.sharded_two_prong_batch(wl, ks, 10, mesh, group=g)
    for f, v in r._asdict().items():
        out[f"tp_batch/{g}/{f}"] = v.numpy()
r = S.sharded_two_prong(wl[0], float(ks[4]), 10, mesh)
for f, v in r._asdict().items():
    out[f"tp/64/{f}"] = v.numpy()
r = S.sharded_threshold_bisect_batch(wl, ks, 10, mesh)
for f, v in r._asdict().items():
    out[f"bisect_batch/{f}"] = v.numpy()
r = S.sharded_threshold_bisect(wl[0], float(ks[3]), 10, mesh)
for f, v in r._asdict().items():
    out[f"bisect/{f}"] = v.numpy()
h = S.sharded_ht_terms(local(inp["ht_tau"]), local(inp["ht_n"]), mesh)
out["ht"] = torch.stack(h).numpy()
planner = S.DistributedAnyK(mesh, records_per_block=10, candidates=4, max_refills=6,
                            device="cpu")
r = planner.threshold_plan(inp["skew"], 300.0)
out["skew/ids"], out["skew/n_sel"] = planner.plan_block_ids(r), r.num_selected.numpy()
out["skew/sufficient"] = r.sufficient.numpy()
r = planner.bisect_stats_wave(wave, ks)
for f, v in r._asdict().items():
    out[f"bisect_wave/{f}"] = v.numpy()

# -- the bisection's plain rounds by hand: P = 4 on the slab, P = 1 (a group
# of this rank alone) on the whole wave; rounds + 1 calls, an all-reduce a round
from repro_torch.kernels.theta_stats import bisect_carry, bisect_round_batch_plain
solo = [dist.new_group([r]) for r in range(world)][rank]
for p, x, group in ((4, wl, S.shard_group(mesh).group), (1, T(wave), solo)):
    c = bisect_carry(x.shape[0], 16, x.device)
    for r in range(3):
        c = bisect_round_batch_plain(x, T(ks), 10, c, first=r == 0)
        dist.all_reduce(c.stats, group=group)
    c = bisect_round_batch_plain(x, T(ks), 10, c, first=False, stats=False)
    out[f"bisect_plain/{p}/theta"], out[f"bisect_plain/{p}/num_selected"] = c.lo.numpy(), c.n_sel.numpy()
    out[f"bisect_plain/{p}/expected_records"] = c.exp.numpy()

# -- attach_mesh + any_k_batch, both loops
stores = {}
for name, rpb in RPB.items():
    t = Table(dims=inp[f"table/{name}/dims"], measures=inp[f"table/{name}/measures"],
              cards=inp[f"table/{name}/cards"])
    stores[name] = build_block_store(t, rpb, device="cpu")

def save(prefix, batch):
    for i, r in enumerate(batch.results):
        for f in ("record_block", "record_row", "measures", "blocks_fetched"):
            out[f"{prefix}/{i}/{f}"] = getattr(r, f)
        out[f"{prefix}/{i}/rounds_algo"] = np.asarray([r.plan_rounds, ALGOS.index(r.algo)])
    out[f"{prefix}/counters"] = np.asarray([
        batch.rounds, batch.store_blocks_fetched, batch.cache_hits,
        batch.blocks_requested_total, batch.device_transfers])
    out[f"{prefix}/unique"] = batch.unique_blocks_fetched

for case, (table, qs) in CASES.items():
    queries = [BatchQuery(p, k, op) for p, k, op in qs]
    for algo in ALGOS:
        for device in (True, False):
            eng = NeedleTailEngine(stores[table], device="cpu")
            eng.attach_mesh(mesh)
            save(f"wave/{case}/{algo}/{int(device)}", eng.any_k_batch(queries, algo=algo, device=device))

# -- Predicate trees compiled on the slabs of a λ that P does not divide
from repro_torch.core import predicates as tp
exec(TREE_BUILDER)
for device in (True, False):
    eng = NeedleTailEngine(stores[TREES[0]], device="cpu")
    eng.attach_mesh(mesh)
    save(f"trees/{int(device)}", eng.any_k_batch(
        [BatchQuery(_tree(tp, spec), k) for spec, k in TREES[1]], algo="auto", device=device))

# -- the warm replan, both loops: counters and memo
queries = [BatchQuery(p, k, op) for p, k, op in CASES[WARM][1][:3]]
for device in (True, False):
    eng = NeedleTailEngine(stores[WARM], device="cpu")
    eng.attach_mesh(mesh)
    for run in ("cold", "warm"):
        save(f"replan/{int(device)}/{run}", eng.any_k_batch(queries, algo="auto", device=device))
    s = eng.plan_cache.stats
    out[f"replan/{int(device)}/memo"] = np.asarray([
        s.threshold_hits, s.threshold_misses, s.two_prong_hits, s.two_prong_misses,
        s.sharded_threshold_hits, s.sharded_threshold_misses])

# -- group-aligned windows, then the unsharded host loop on the same engine
queries = [BatchQuery(p, k, op) for p, k, op in CASES[WARM][1][::2]]
eng = NeedleTailEngine(stores[WARM], device="cpu")
eng.attach_mesh(mesh, two_prong_group=4)
save("group4/sharded", eng.any_k_batch(queries, algo="two_prong", device=False))
save("group4/device", eng.any_k_batch(queries, algo="two_prong", device=True))
save("group4/host", eng.any_k_batch(queries, algo="two_prong", sharded=False, device=False))

# -- fetch_plan through the engine's block cache
store = stores[WARM]
eng = NeedleTailEngine(store, device="cpu")
pl = S.DistributedAnyK(mesh, records_per_block=store.records_per_block,
                       candidates=store.num_blocks, block_cache=eng.block_cache, device="cpu")
comb = eng.combined_density([(0, 1)])
ids, bd, bm, bv = pl.fetch_plan(store, pl.threshold_plan(comb, 64.0))
ref = store.fetch(ids)
same = all(torch.equal(a, b) for a, b in zip((bd, bm, bv), ref))
cached = all(int(b) in eng.block_cache for b in ids)
default_priced = pl.last_fetch_io_s == make_cost_model("ici").io_time(ids)
pl.remote_cost = make_cost_model("hdd")
pl.fetch_plan(store, pl.threshold_plan(comb, 64.0))
priced = pl.last_fetch_io_s == make_cost_model("hdd").io_time(ids)
reads0 = eng.block_cache.stats.store_blocks_fetched
r = eng.any_k([(0, 1)], 64, algo="threshold")
new = {int(b) for b in r.blocks_fetched} - {int(b) for b in ids}
out["fetch"] = np.asarray([ids.size, same, cached, default_priced, priced,
                           eng.block_cache.stats.store_blocks_fetched - reads0 == len(new)])
out["fetch/ids"] = ids
np.savez(f"{io}/rank{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _launch_ranks(tmp: pathlib.Path, code: str, args: list[str]) -> list[dict]:
    """Run ``code`` as P ranks (``python -c``) and return each rank's npz.
    Every rank is killed if the launch outlives ``RANK_TIMEOUT_S``."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    init = f"file://{tmp}/rendezvous"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(P), init, str(tmp), *args],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(P)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(P)]


# ---------------------------------------------------------------------------
# The reference at P = 4: one process with four forced host devices.
# ---------------------------------------------------------------------------

REF_CODE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.core import sharded as S
from repro.core.engine import NeedleTailEngine
from repro.core.multi_query import BatchQuery
from repro.data.block_store import Table, build_block_store
from repro.kernels.density_combine import density_combine_batch_sharded

# the scalar planners run their shard_map op by op unless jitted (seconds a
# call); jit them, as the wave planners already are
S.sharded_threshold = jax.jit(S.sharded_threshold, static_argnums=(2, 3, 4, 5))
S.sharded_two_prong = jax.jit(S.sharded_two_prong, static_argnums=(2, 3, 4, 5))
S.sharded_threshold_bisect = jax.jit(S.sharded_threshold_bisect, static_argnums=(2, 3, 4, 5, 6))
S.sharded_ht_terms = jax.jit(S.sharded_ht_terms, static_argnums=(2, 3))

io = sys.argv[1]
CASES, RPB, ALGOS, WARM, CANDS, _, _ = json.loads(sys.argv[2])
mesh = jax.make_mesh((4,), ("data",))
inp = dict(np.load(f"{io}/inputs.npz"))
out = {}
rm = jnp.asarray(inp["combine/rm"])
for key in [k for k in inp if k.startswith("combine/") and k.endswith("/dens")]:
    dens = inp[key]
    if dens.shape[1] % 4:
        continue  # a jax sharding needs λ a multiple of P
    sd = S.shard_density_maps(jnp.asarray(dens), mesh)
    for op in ("and", "or"):
        out[f"{key[:-5]}/{op}"] = np.asarray(density_combine_batch_sharded(sd, rm, mesh, op))
        out[f"{key[:-5]}/{op}/kernel"] = np.asarray(density_combine_batch_sharded(
            sd, rm, mesh, op, use_kernel=True, interpret=True))

wave, ks = inp["wave"], inp["wave_ks"]
ws = S.shard_density_maps(jnp.asarray(wave), mesh)
for c in CANDS:
    r = S.sharded_threshold_batch(ws, ks, 10, mesh, candidates=c)
    for f, v in r._asdict().items():
        out[f"th_batch/{c}/{f}"] = np.asarray(v)
    r = S.sharded_threshold(jnp.asarray(wave[2]), float(ks[2]), 10, mesh, "data", c)
    for f, v in r._asdict().items():
        out[f"th/{c}/{f}"] = np.asarray(v)
for g in (1, 4, 16):
    r = S.sharded_two_prong_batch(ws, ks, 10, mesh, group=g)
    for f, v in r._asdict().items():
        out[f"tp_batch/{g}/{f}"] = np.asarray(v)
r = S.sharded_two_prong(jnp.asarray(wave[0]), float(ks[4]), 10, mesh, "data", 64)
for f, v in r._asdict().items():
    out[f"tp/64/{f}"] = np.asarray(v)
r = S.sharded_threshold_bisect_batch(ws, ks, 10, mesh)
for f, v in r._asdict().items():
    out[f"bisect_batch/{f}"] = np.asarray(v)
r = S.sharded_threshold_bisect(jnp.asarray(wave[0]), float(ks[3]), 10, mesh, "data", 3, 16)
for f, v in r._asdict().items():
    out[f"bisect/{f}"] = np.asarray(v)
h = S.sharded_ht_terms(jnp.asarray(inp["ht_tau"]), jnp.asarray(inp["ht_n"]), mesh, "data")
out["ht"] = np.asarray([float(h[0]), float(h[1])], np.float32)
planner = S.DistributedAnyK(mesh, records_per_block=10, candidates=4, max_refills=6)
r = planner.threshold_plan(jnp.asarray(inp["skew"]), 300.0)
out["skew/ids"], out["skew/n_sel"] = planner.plan_block_ids(r), np.asarray(r.num_selected)
out["skew/sufficient"] = np.asarray(r.sufficient)
r = planner.bisect_stats_wave(wave, ks)
for f, v in r._asdict().items():
    out[f"bisect_wave/{f}"] = np.asarray(v)
mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
r = S.sharded_threshold_bisect_batch(S.shard_density_maps(jnp.asarray(wave), mesh1), ks, 10, mesh1)
for f, v in r._asdict().items():
    out[f"bisect_batch_p1/{f}"] = np.asarray(v)

stores = {}
for name, rpb in RPB.items():
    t = Table(dims=inp[f"table/{name}/dims"], measures=inp[f"table/{name}/measures"],
              cards=inp[f"table/{name}/cards"])
    stores[name] = build_block_store(t, rpb)

def save(prefix, batch):
    for i, r in enumerate(batch.results):
        for f in ("record_block", "record_row", "measures", "blocks_fetched"):
            out[f"{prefix}/{i}/{f}"] = np.asarray(getattr(r, f))
        out[f"{prefix}/{i}/rounds_algo"] = np.asarray([r.plan_rounds, ALGOS.index(r.algo)])
    out[f"{prefix}/counters"] = np.asarray([
        batch.rounds, batch.store_blocks_fetched, batch.cache_hits,
        batch.blocks_requested_total, batch.device_transfers])
    out[f"{prefix}/unique"] = np.asarray(batch.unique_blocks_fetched)

queries = [BatchQuery(p, k, op) for p, k, op in CASES[WARM][1][:3]]
for device in (True, False):
    eng = NeedleTailEngine(stores[WARM])
    eng.attach_mesh(mesh)
    for run in ("cold", "warm"):
        save(f"replan/{int(device)}/{run}", eng.any_k_batch(queries, algo="auto", device=device))
    s = eng.plan_cache.stats
    out[f"replan/{int(device)}/memo"] = np.asarray([
        s.threshold_hits, s.threshold_misses, s.two_prong_hits, s.two_prong_misses,
        s.sharded_threshold_hits, s.sharded_threshold_misses])
queries = [BatchQuery(p, k, op) for p, k, op in CASES[WARM][1][::2]]
eng = NeedleTailEngine(stores[WARM])
eng.attach_mesh(mesh, two_prong_group=4)
save("group4/sharded", eng.any_k_batch(queries, algo="two_prong"))
save("group4/device", eng.any_k_batch(queries, algo="two_prong", device=True))
save("group4/host", eng.any_k_batch(queries, algo="two_prong", sharded=False))
np.savez(f"{io}/ref.npz", **out)
"""


def _config() -> str:
    return json.dumps([CASES, RPB, list(ALGOS), WARM, list(THRESHOLD_CANDIDATES), TREES,
                       inspect.getsource(_tree)])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write the inputs, run the reference at P = 4 and the port's four ranks
    side by side, and return ``(inputs, ref, [rank outputs])``."""
    tmp = tmp_path_factory.mktemp("sharded")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(tmp)), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", REF_CODE, str(tmp), _config()], cwd=REPO,
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = _launch_ranks(tmp, RANK_CODE, [_config()])
        log = ref.communicate(timeout=RANK_TIMEOUT_S)[0]
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-3000:]
    return inputs, dict(np.load(tmp / "ref.npz")), ranks


@pytest.fixture(scope="module")
def stores(run):
    inputs = run[0]
    return {name: jax_build_block_store(
        JaxTable(dims=inputs[f"table/{name}/dims"], measures=inputs[f"table/{name}/measures"],
                 cards=inputs[f"table/{name}/cards"]), rpb) for name, rpb in RPB.items()}


def _shard(x: np.ndarray, r: int) -> np.ndarray:
    w = -(-x.shape[-1] // P)
    part = x[..., r * w:(r + 1) * w]
    return np.pad(part, [(0, 0)] * (x.ndim - 1) + [(0, w - part.shape[-1])])


def _assert_saved_equal(mine: dict, ref: dict, prefix: str, n: int, counters=True):
    for i in range(n):
        for f in ("record_block", "record_row", "measures", "rounds_algo"):
            np.testing.assert_array_equal(mine[f"{prefix}/{i}/{f}"], ref[f"{prefix}/{i}/{f}"],
                                          err_msg=f"{prefix} query {i} {f}")
        np.testing.assert_array_equal(np.sort(mine[f"{prefix}/{i}/blocks_fetched"]),
                                      np.sort(ref[f"{prefix}/{i}/blocks_fetched"]))
    if counters:
        np.testing.assert_array_equal(mine[f"{prefix}/counters"], ref[f"{prefix}/counters"])
        np.testing.assert_array_equal(mine[f"{prefix}/unique"], ref[f"{prefix}/unique"])


def _saved_batch(batch) -> dict:
    out = {}
    for i, r in enumerate(batch.results):
        for f in ("record_block", "record_row", "measures", "blocks_fetched"):
            out[f"b/{i}/{f}"] = np.asarray(getattr(r, f))
        out[f"b/{i}/rounds_algo"] = np.asarray([r.plan_rounds, ALGOS.index(r.algo)])
    out["b/counters"] = np.asarray([batch.rounds, batch.store_blocks_fetched,
                                    batch.cache_hits, batch.blocks_requested_total])
    out["b/unique"] = np.asarray(batch.unique_blocks_fetched)
    return out


# ---------------------------------------------------------------------------
# #3 and the planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("lam", [4 * 96, 235])
def test_sharded_combine_bit_identical_to_reference_on_every_rank(run, lam, op):
    inputs, ref, ranks = run
    if lam % P == 0:
        full, kernel = ref[f"combine/{lam}/{op}"], ref[f"combine/{lam}/{op}/kernel"]
        np.testing.assert_array_equal(full, kernel)
    else:  # the reference cannot shard this λ: its unsharded combine's columns
        from repro.core.density_map import combine_densities_batch_np

        full = combine_densities_batch_np(inputs[f"combine/{lam}/dens"], inputs["combine/rm"], op)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"combine/{lam}/{op}"], _shard(full, r), err_msg=f"rank {r}")


@pytest.mark.parametrize("c", THRESHOLD_CANDIDATES)
def test_sharded_threshold_equals_reference_at_p4(run, c):
    _, ref, ranks = run
    for out in ranks:
        for kind in ("th_batch", "th"):
            for f in ("block_ids", "num_selected", "sufficient"):
                np.testing.assert_array_equal(out[f"{kind}/{c}/{f}"], ref[f"{kind}/{c}/{f}"],
                                              err_msg=f"{kind} C={c} {f}")
            np.testing.assert_array_equal(out[f"{kind}/{c}/expected_records"],
                                          ref[f"{kind}/{c}/expected_records"])


@pytest.mark.parametrize("g", [1, 4, 16, 64])
def test_sharded_two_prong_equals_reference_at_p4(run, g):
    _, ref, ranks = run
    kind = "tp" if g == 64 else "tp_batch"
    for out in ranks:
        for f in ("start_block", "end_block"):
            np.testing.assert_array_equal(out[f"{kind}/{g}/{f}"], ref[f"{kind}/{g}/{f}"])
        np.testing.assert_allclose(out[f"{kind}/{g}/expected_records"],
                                   ref[f"{kind}/{g}/expected_records"], rtol=RTOL)


def test_sharded_two_prong_group1_equals_single_device_windows(run):
    from repro.core.two_prong import two_prong_select_batch

    inputs, _, ranks = run
    w = two_prong_select_batch(inputs["wave"], inputs["wave_ks"], WAVE_RPB)
    for out in ranks:
        np.testing.assert_array_equal(out["tp_batch/1/start_block"], np.asarray(w.start))
        np.testing.assert_array_equal(out["tp_batch/1/end_block"], np.asarray(w.end))


@pytest.mark.parametrize("kind", ["bisect_batch", "bisect", "bisect_wave"])
def test_sharded_bisect_equals_reference_at_p4(run, kind):
    """θ and the counts exact, the sums within ``rtol``; a θ that differs
    would be a boundary case (a threshold whose record mass lies within
    ``rtol`` of k), and none is expected on these rows."""
    _, ref, ranks = run
    for out in ranks:
        np.testing.assert_array_equal(out[f"{kind}/theta"], ref[f"{kind}/theta"])
        np.testing.assert_array_equal(out[f"{kind}/num_selected"], ref[f"{kind}/num_selected"])
        np.testing.assert_allclose(out[f"{kind}/expected_records"],
                                   ref[f"{kind}/expected_records"], rtol=RTOL)


@pytest.mark.parametrize("p", [1, 4])
def test_bisect_plain_rounds_equal_reference_at_p1_and_p4(run, p):
    """The batched bisection's plain rounds (``bisect_round_batch_plain``, a
    step and the statistics a call, an all-reduce between calls) against the
    reference's ``sharded_threshold_bisect_batch`` at P = 1 and P = 4: θ* and
    ``n_sel`` per query exact, ``exp`` within ``rtol`` (sums in another
    order; no boundary case on these rows)."""
    _, ref, ranks = run
    want = "bisect_batch" if p == 4 else "bisect_batch_p1"
    for out in ranks:
        for f in ("theta", "num_selected"):
            np.testing.assert_array_equal(out[f"bisect_plain/{p}/{f}"], ref[f"{want}/{f}"])
        np.testing.assert_allclose(out[f"bisect_plain/{p}/expected_records"],
                                   ref[f"{want}/expected_records"], rtol=RTOL)


def test_sharded_ht_terms_equal_reference(run):
    _, ref, ranks = run
    for out in ranks:
        np.testing.assert_allclose(out["ht"], ref["ht"], rtol=RTOL)


def test_skewed_frontier_refills_to_the_exact_plan(run):
    """All density on shard 0: the frontier of 4 doubles until the plan is
    the single-device THRESHOLD's (the reference's ``test_extensions``)."""
    from repro.core.threshold import threshold_select

    inputs, ref, ranks = run
    exact = threshold_select(inputs["skew"], 300.0, 10)
    exact_ids = np.sort(np.asarray(exact.block_ids)[: int(exact.num_selected)])
    for out in ranks:
        assert bool(out["skew/sufficient"]) and bool(ref["skew/sufficient"])
        np.testing.assert_array_equal(out["skew/ids"], ref["skew/ids"])
        np.testing.assert_array_equal(out["skew/ids"], exact_ids)


# ---------------------------------------------------------------------------
# attach_mesh + any_k_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_attached_mesh_waves_equal_reference_any_k_batch(run, stores, case, algo):
    """Every rank's device wave and host-mirror loop give the reference's
    (unsharded, host-mirror) ``any_k_batch`` query for query, with its
    rounds, store reads and cache hits."""
    _, _, ranks = run
    table, qs = CASES[case]
    ref = _saved_batch(JaxEngine(stores[table]).any_k_batch(
        [JaxQuery(p, k, op) for p, k, op in qs], algo=algo))
    for out in ranks:
        for device in (1, 0):
            prefix = f"wave/{case}/{algo}/{device}"
            mine = {k.replace(prefix, "b"): v for k, v in out.items() if k.startswith(prefix)}
            mine["b/counters"] = mine["b/counters"][:4]
            _assert_saved_equal(mine, ref, "b", len(qs))
            transfers, rounds = out[f"{prefix}/counters"][4], out[f"{prefix}/counters"][0]
            assert rounds <= transfers <= rounds + 1 if device else transfers == 0


def test_trees_on_shards_of_an_uneven_lambda_equal_reference(run, stores):
    """Predicate trees with a Not compiled on each rank's slab of λ = 235
    at P = 4: both loops give the reference's (unsharded) results."""
    from repro.core import predicates as jp

    _, _, ranks = run
    ref = _saved_batch(JaxEngine(stores[TREES[0]]).any_k_batch(
        [JaxQuery(_tree(jp, spec), k) for spec, k in TREES[1]], algo="auto"))
    for out in ranks:
        for device in (1, 0):
            prefix = f"trees/{device}"
            mine = {k.replace(prefix, "b"): v for k, v in out.items() if k.startswith(prefix)}
            mine["b/counters"] = mine["b/counters"][:4]
            _assert_saved_equal(mine, ref, "b", len(TREES[1]))


def test_disjoint_queries_plan_on_opposite_shards(run):
    _, _, ranks = run
    for out in ranks:
        s0 = set(out["wave/disjoint_pair/threshold/1/0/blocks_fetched"].tolist())
        s1 = set(out["wave/disjoint_pair/threshold/1/1/blocks_fetched"].tolist())
        assert s0 and s1 and not s0 & s1 and max(s0) < 16 and min(s1) >= 48


@pytest.mark.parametrize("device", [1, 0], ids=["device_wave", "host_mirror"])
def test_warm_replan_reads_nothing_with_the_reference_counters(run, device):
    """The repeat wave on one engine: 0 store reads, and the cache and
    (sharded) memo counters of the reference's sharded engine at P = 4."""
    _, ref, ranks = run
    for out in ranks:
        for when in ("cold", "warm"):
            _assert_saved_equal(out, ref, f"replan/{device}/{when}", 3)
        np.testing.assert_array_equal(out[f"replan/{device}/memo"], ref[f"replan/{device}/memo"])
        rounds, reads, hits = out[f"replan/{device}/warm/counters"][:3]
        assert reads == 0 and hits > 0
        if not device:
            assert out["replan/0/memo"][4] > 0  # sharded THRESHOLD memo hits


def test_group_aligned_windows_do_not_poison_the_memo(run, stores):
    """``two_prong_group=4`` windows equal the reference's; the unsharded
    loop on the same engine afterwards still gives exact windows."""
    _, ref, ranks = run
    qs = CASES[WARM][1][::2]
    exact = _saved_batch(JaxEngine(stores[WARM], cache_bytes=0).any_k_batch(
        [JaxQuery(p, k, op) for p, k, op in qs], algo="two_prong"))
    for out in ranks:
        _assert_saved_equal(out, ref, "group4/sharded", len(qs))
        _assert_saved_equal(out, ref, "group4/device", len(qs))
        _assert_saved_equal(out, ref, "group4/host", len(qs))
        _assert_saved_equal({k.replace("group4/host", "b"): v for k, v in out.items()},
                            exact, "b", len(qs), counters=False)


def test_fetch_plan_shares_the_engine_cache(run):
    _, _, ranks = run
    for out in ranks:
        n, same, cached, default_priced, priced, hits_reused = out["fetch"]
        assert n > 0 and same and cached and default_priced and priced and hits_reused
        np.testing.assert_array_equal(out["fetch/ids"], ranks[0]["fetch/ids"])


def test_every_rank_ends_with_the_same_outputs(run):
    _, _, ranks = run
    for out in ranks[1:]:
        for key, v in ranks[0].items():
            if not key.startswith("combine/"):  # #3's outputs are per-slab
                np.testing.assert_array_equal(out[key], v, err_msg=key)


# ---------------------------------------------------------------------------
# A world of one, in this process
# ---------------------------------------------------------------------------

def test_world_of_one_in_process(tmp_path):
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.multi_query import BatchQuery
    from repro_torch.data.block_store import Table, build_block_store
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(device_type="cpu")
    dims, measures, cards = _tables()["skewed"]
    store = build_block_store(Table(dims=dims, measures=measures, cards=cards), RPB["skewed"],
                              device="cpu")
    jstore = jax_build_block_store(JaxTable(dims=dims, measures=measures, cards=cards),
                                   RPB["skewed"])
    qs = CASES["skewed"][1]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(device_type="cpu")
        eng = NeedleTailEngine(store, device="cpu")
        with pytest.raises(ValueError, match="no mesh attached"):
            eng.any_k_batch([BatchQuery(*q) for q in qs], sharded=True)
        eng.attach_mesh(mesh)
        assert eng.distributed.num_shards == 1
        for algo in ALGOS:
            ref = _saved_batch(JaxEngine(jstore).any_k_batch(
                [JaxQuery(*q) for q in qs], algo=algo))
            for device in (True, False):
                mine = _saved_batch(eng.any_k_batch([BatchQuery(*q) for q in qs], algo=algo,
                                                    device=device))
                _assert_saved_equal(mine, ref, "b", len(qs), counters=False)
        eng.detach_mesh()
        assert eng.distributed is None
    finally:
        dist.destroy_process_group()


def test_one_combine_call_per_wave_on_a_mixed_wave(tmp_path, monkeypatch):
    """A wave of AND and OR queries: the device wave's joiners are combined
    in one call (``_flush_joins``), the host mirror makes one call per
    planned (round, algorithm) group (``_combined_matrix``, exclusions
    included), and with a sharded planner the device wave's joiners are one
    call of #3 on the rank's slab (``combine_wave``)."""
    from repro_torch.core import multi_query
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.multi_query import BatchQuery
    from repro_torch.data.block_store import Table, build_block_store
    from repro_torch.kernels import density_combine
    from repro_torch.launch.mesh import make_host_mesh

    calls, plans = [], []
    combine, plan = density_combine._combine_wave, multi_query._plan_wave
    monkeypatch.setattr(density_combine, "_combine_wave",
                        lambda name, *a: (calls.append(name), combine(name, *a))[1])
    monkeypatch.setattr(multi_query, "_plan_wave",
                        lambda *a, **k: (plans.append(1), plan(*a, **k))[1])
    dims, measures, cards = _tables()["clustered"]
    store = build_block_store(Table(dims=dims, measures=measures, cards=cards),
                              RPB["clustered"], device="cpu")
    queries = [BatchQuery(*q) for q in CASES["clustered"][1]]
    assert {q.op for q in queries} == {"and", "or"}
    eng = NeedleTailEngine(store, device="cpu")
    eng.any_k_batch(queries, device=True)
    assert calls == ["density_combine_batch"]
    calls.clear()
    batch = eng.any_k_batch(queries, algo="auto", device=False)  # 2 rounds: exclusions
    assert calls == ["density_combine_batch"] * len(plans) and len(plans) >= batch.rounds > 1
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        eng.attach_mesh(make_host_mesh(device_type="cpu"))
        calls.clear()
        eng.any_k_batch(queries, device=True)
        assert calls == ["density_combine_batch_sharded"]
    finally:
        dist.destroy_process_group()


def test_chip_smoke_sharded_phases_pass_on_a_small_cpu_store(tmp_path):
    """chip_smoke.py's sharded phase (a world of one, in this process) and
    its sharded_ranks phase (two CPU ranks of the script) at a small size on
    the plain versions."""
    import importlib.util

    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.data import synthetic
    from repro_torch.data.block_store import build_block_store

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    records = 300_000
    table = synthetic.make_real_like_table("airline", num_records=records, seed=0)
    store = build_block_store(table, cs.RPB, device="cpu")
    queries = cs.make_wave(table.cards, cs.Q, seed=0)
    eng = NeedleTailEngine(store, device="cpu")
    batch, warm = eng.any_k_batch(queries), eng.any_k_batch(queries)
    rows = cs.combined_rows(store, queries)

    def run(name, fn):
        return fn(), 0.0, {}

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        sh = cs.sharded_check(store, queries, batch, warm, rows, run, device="cpu")
    finally:
        dist.destroy_process_group()
    assert sh["bisect"]["equal"] + sh["bisect"]["boundary"] == len(queries)
    assert sh["digest"] == cs.wave_digest(batch) and sh["transfers"] <= batch.rounds + 1
    ranks = cs.launch_ranks(records, 0, 2, device="cpu", timeout=RANK_TIMEOUT_S)
    for r in ranks:
        assert r["shards"] == 2 and r["lam_local"] == -(-store.num_blocks // 2)
        assert r["digests"]["cold"] == r["digests"]["host_mirror"] == sh["digest"]
        assert r["digests"]["warm"] == cs.wave_digest(warm)


def test_sharded_memo_books_as_the_reference():
    """The sharded THRESHOLD memo: the same put / get / peek sequence gives
    the reference's hits, misses, values and evictions."""
    from repro.core.block_cache import PlanOrderCache as JaxPlanOrderCache
    from repro_torch.core.block_cache import PlanOrderCache

    mine, ref = PlanOrderCache(max_entries=2), JaxPlanOrderCache(max_entries=2)
    rows = [np.full(4, v, np.float32).tobytes() for v in (0.5, 0.25, 0.125)]
    steps = [("get", 0, 10.0), ("put", 0, 10.0), ("get", 0, 10.0), ("get", 0, 11.0),
             ("put", 1, 10.0), ("peek", 0, 10.0), ("put", 2, 10.0), ("peek", 0, 10.0),
             ("get", 1, 10.0), ("get", 2, 10.0), ("get", 0, 10.0)]
    for op, r, need in steps:
        if op == "put":
            ids = np.arange(r + 1, dtype=np.int64)
            mine.put_sharded_threshold(rows[r], need, ids)
            ref.put_sharded_threshold(rows[r], need, ids)
            continue
        a = getattr(mine, f"{op}_sharded_threshold")(rows[r], need)
        b = getattr(ref, f"{op}_sharded_threshold")(rows[r], need)
        assert (a is None) == (b is None), (op, r, need)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for f in ("sharded_threshold_hits", "sharded_threshold_misses", "hits"):
        assert getattr(mine.stats, f) == getattr(ref.stats, f), f
    assert mine.stats.sharded_threshold_hits == 3
