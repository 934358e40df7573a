"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

The kernels have no CPU or interpret mode, so every case here carries the
``cuda`` marker and skips where there is no card.  The file imports neither
JAX nor the JAX package, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The combines, the gather and the prefix scan must match bit for bit, the
θ-counts exactly and the θ-sums to ``rtol=1e-5`` (the same f32 terms in
another order).  Flash attention (#8) in f32 and the SSD scan (#9) are held
at the reference's own tolerances (``tests/test_kernels.py``): attention
2e-3, the SSD atol 2e-3 / rtol 1e-2.  #8 in bf16 reads bf16 values and sums
in f32, so it is held against the f32 plain version on the same values
upcast, to the output's own bf16 rounding: rtol 2⁻⁷ (one bf16 ulp), atol
1e-4.  #9 also runs with slow decay, where the state carried across
chunks is most of the output, over 64 chunks, over a chunk of pad tokens
whose decays would overflow an unmasked exp, and with its final state.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_plain, flash_attention
from repro_torch.kernels.ssd_chunk import CHUNK, ssd_chunked, ssd_scan
from repro_torch.kernels.density_combine import (
    density_combine, density_combine_batch, density_combine_batch_plain,
    density_combine_batch_sharded, density_combine_plain,
)
from repro_torch.kernels.plan_wave import block_gather, block_gather_plain
from repro_torch.kernels.theta_stats import (
    theta_stats, theta_stats_batch, theta_stats_batch_plain, theta_stats_plain,
)
from repro_torch.kernels.window_scan import prefix_sum, prefix_sum_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _combine_inputs(seed: int, q: int, gamma: int, lam: int, rows: int = 12):
    rng = np.random.default_rng(seed)
    dens = (rng.random((rows, lam)) ** 2).astype(np.float32)
    dens[rng.random((rows, lam)) < 0.2] = 0.0
    rm = rng.integers(0, rows, (q, gamma)).astype(np.int32)
    for i in range(q):
        rm[i, rng.integers(1, gamma + 1):] = -1
    return torch.from_numpy(dens), torch.from_numpy(rm)


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("seed,q,gamma,lam", [(0, 8, 3, 1000), (1, 5, 2, 512), (2, 1, 1, 37),
                                              (3, 64, 3, 12208)])
def test_combine_kernel_bit_identical_to_plain(cuda, op, seed, q, gamma, lam):
    dens, rm = _combine_inputs(seed, q, gamma, lam)
    n0 = _lib.LAUNCHES["density_combine_batch"]
    out = density_combine_batch(dens.to(cuda), rm.to(cuda), op)
    assert _lib.LAUNCHES["density_combine_batch"] == n0 + 1
    assert torch.equal(out, density_combine_batch_plain(dens.to(cuda), rm.to(cuda), op))
    assert torch.equal(out.cpu(), density_combine_batch_plain(dens, rm, op))


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("gamma,shards,lam", [(3, 4, 12208), (3, 1, 12208), (1, 4, 1000),
                                              (2, 3, 1000), (5, 4, 4096), (2, 7, 37)])
def test_sharded_combine_kernel_bit_identical_to_plain(cuda, op, gamma, shards, lam):
    """#3 on every rank's slab of a λ-sharded index (λ_local = ⌈λ/P⌉, the
    last slab zero-padded; 3052, 334, 6 are not multiples of the kernel's
    256-block tile): bit for bit its plain version and the whole index's
    combine, counted as its own launch."""
    from repro_torch.core.sharded import local_width

    dens, rm = _combine_inputs(gamma, 64, gamma, lam)
    dens, rm = dens.to(cuda), rm.to(cuda)
    full = density_combine_batch(dens, rm, op)
    w = local_width(lam, shards)
    padded = torch.nn.functional.pad(dens, (0, w * shards - lam))
    for r in range(shards):
        slab = padded[:, r * w:(r + 1) * w].contiguous()
        n0 = _lib.LAUNCHES["density_combine_batch_sharded"]
        out = density_combine_batch_sharded(slab, rm, None, op)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["density_combine_batch_sharded"] == n0 + 1
        assert torch.equal(out, density_combine_batch_plain(slab, rm, op))
        hi = min((r + 1) * w, lam) - r * w
        if hi > 0:
            assert torch.equal(out[:, :hi], full[:, r * w:r * w + hi])


def test_world_of_one_nccl_sharded_wave_equals_the_device_wave(cuda, tmp_path):
    """A world of one over NCCL on the card: ``attach_mesh`` + the device
    wave and the host-mirror loop equal the unsharded device wave, and the
    sharded path launches #3."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.multi_query import BatchQuery
    from repro_torch.data.block_store import build_block_store
    from repro_torch.data.synthetic import make_clustered_table
    from repro_torch.launch.mesh import make_host_mesh

    t = make_clustered_table(num_records=64_000, num_dims=4, density=0.15, seed=2)
    store = build_block_store(t, 100, device=cuda)
    qs = [BatchQuery([(0, 1), (2, 1)], 300), BatchQuery([(0, 1)], 50),
          BatchQuery([(1, 1), (3, 1)], 2000, "or"), BatchQuery([(2, 0)], 10, algo="two_prong")]
    ref = NeedleTailEngine(store, device=cuda).any_k_batch(qs)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60),
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        eng = NeedleTailEngine(store, device=cuda)
        eng.attach_mesh(make_host_mesh())
        n0 = _lib.LAUNCHES["density_combine_batch_sharded"]
        waves = [eng.any_k_batch(qs), NeedleTailEngine(store, device=cuda).any_k_batch(
            qs, device=False, sharded=False)]
        host = NeedleTailEngine(store, device=cuda)
        host.attach_mesh(make_host_mesh())
        waves.append(host.any_k_batch(qs, device=False))
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["density_combine_batch_sharded"] > n0
    finally:
        dist.destroy_process_group()
    for w in waves:
        for a, b in zip(w.results, ref.results):
            for f in ("record_block", "record_row", "measures"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert (a.plan_rounds, a.algo) == (b.plan_rounds, b.algo)
        assert (w.rounds, w.store_blocks_fetched, w.cache_hits) == \
            (ref.rounds, ref.store_blocks_fetched, ref.cache_hits)


@pytest.mark.parametrize("seed,q,lam", [(0, 8, 1000), (1, 64, 12208), (2, 1, 7), (3, 3, 0)])
def test_theta_kernel_against_plain(cuda, seed, q, lam):
    rng = np.random.default_rng(seed)
    x = (rng.random((q, lam)) ** 3).astype(np.float32)
    x[rng.random((q, lam)) < 0.3] = 0.0
    th = np.sort(rng.random((q, 8)).astype(np.float32), axis=1)
    th[0] = 0.0
    xc, tc = torch.from_numpy(x).to(cuda), torch.from_numpy(th).to(cuda)
    counts, recsum = theta_stats_batch(xc, tc)
    pc, ps = theta_stats_batch_plain(xc, tc)
    assert torch.equal(counts, pc)
    torch.testing.assert_close(recsum, ps, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype,d", [(torch.int32, 5), (torch.float32, 3), (torch.int8, 0)])
@pytest.mark.parametrize("r", [50, 8192])
def test_gather_kernel_bit_identical_to_plain(cuda, dtype, d, r):
    g = torch.Generator().manual_seed(r)
    shape = (12, r, d) if d else (12, r)
    slab = torch.randint(-100, 100, shape, generator=g).to(dtype).to(cuda)
    for ids in ([3, 0, 7], [2, 2, 5, 2], list(range(11, -1, -1))):
        i = torch.tensor(ids, dtype=torch.int32, device=cuda)
        assert torch.equal(block_gather(slab, i), block_gather_plain(slab, i))
    n0 = _lib.LAUNCHES["block_gather"]
    empty = block_gather(slab, torch.zeros((0,), dtype=torch.int32, device=cuda))
    assert empty.shape == (0, *slab.shape[1:]) and _lib.LAUNCHES["block_gather"] == n0


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("gamma,lam", [(1, 37), (2, 1000), (3, 12208), (5, 4096)])
def test_single_combine_kernel_bit_identical_to_plain(cuda, op, gamma, lam):
    dens, _ = _combine_inputs(gamma, 1, 1, lam)
    rows = torch.from_numpy(np.random.default_rng(lam).integers(0, 12, gamma).astype(np.int32))
    n0 = _lib.LAUNCHES["density_combine"]
    out = density_combine(dens.to(cuda), rows.to(cuda), op)
    assert _lib.LAUNCHES["density_combine"] == n0 + 1
    assert torch.equal(out.cpu(), density_combine_plain(dens, rows, op))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 65537, 12208,
                               2048, 2049, 2304, 6144])
def test_prefix_sum_kernel_bit_identical_to_plain(cuda, n):
    rng = np.random.default_rng(n)
    x = (rng.random(n) ** 4).astype(np.float32)
    x[rng.random(n) < 0.3] = 0.0
    n0 = _lib.LAUNCHES["prefix_sum"]
    out = prefix_sum(torch.from_numpy(x).to(cuda))
    assert _lib.LAUNCHES["prefix_sum"] == n0 + 1
    assert torch.equal(out.cpu(), prefix_sum_plain(torch.from_numpy(x)))


@pytest.mark.parametrize("q,n", [(64, 12208), (3, 17), (5, 4097), (2, 0)])
def test_batched_prefix_sum_kernel_bit_identical_to_plain(cuda, q, n):
    rng = np.random.default_rng(q * n)
    x = torch.from_numpy((rng.normal(size=(q, n)) * 100).astype(np.float32))
    out = prefix_sum(x.to(cuda))
    assert torch.equal(out.cpu(), prefix_sum_plain(x))
    assert torch.equal(out, prefix_sum_plain(x.to(cuda)))


@pytest.mark.parametrize("q", [1, 64])
@pytest.mark.parametrize("past", [0, 1], ids=["smem_max_n", "smem_max_n_plus_1"])
def test_prefix_sum_kernel_at_the_shared_memory_edge(cuda, q, past):
    """The longest row the shared-memory (cluster) branch takes and one
    longer, which takes the global-scratch branch of the same launch: one
    launch each, bit for bit the plain version, as a [λ] row and as
    [64, λ]."""
    from repro_torch.kernels.window_scan import SMEM_MAX_N

    lib = _lib.load()
    assert lib.nt_prefix_sum_smem_max_n() == SMEM_MAX_N
    n = SMEM_MAX_N + past
    assert lib.nt_prefix_sum_scratch_floats(n) == (0 if past == 0 else 4373)
    rng = np.random.default_rng(n + q)
    x = (rng.random((q, n)) ** 4).astype(np.float32)
    x[rng.random((q, n)) < 0.3] = 0.0
    xc = torch.from_numpy(x).to(cuda)
    if q == 1:
        xc = xc[0]
    n0 = _lib.LAUNCHES["prefix_sum"]
    out = prefix_sum(xc)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["prefix_sum"] == n0 + 1
    assert torch.equal(out, prefix_sum_plain(xc))
    assert torch.equal(out.cpu(), prefix_sum_plain(xc.cpu()))


@pytest.mark.parametrize("lam,T", [(12208, 16), (1000, 1), (7, 9), (5000, 32), (10**6, 20),
                                   (0, 3)])
def test_single_theta_kernel_against_plain(cuda, lam, T):
    rng = np.random.default_rng(lam + T)
    x = (rng.random(lam) ** 3).astype(np.float32)
    x[rng.random(lam) < 0.3] = 0.0
    th = np.sort(rng.random(T).astype(np.float32))
    th[0] = 0.0
    xc, tc = torch.from_numpy(x).to(cuda), torch.from_numpy(th).to(cuda)
    n0 = _lib.LAUNCHES["theta_stats"]
    counts, recsum = theta_stats(xc, tc)
    assert _lib.LAUNCHES["theta_stats"] == n0 + 1
    pc, ps = theta_stats_plain(xc, tc)
    assert torch.equal(counts, pc)
    torch.testing.assert_close(recsum, ps, rtol=1e-5, atol=0)
    again = theta_stats(xc, tc)[1]
    assert torch.equal(again, recsum)  # a fixed order: the same bits every run


def test_threshold_bisect_on_the_kernel_matches_the_plain_steps(cuda):
    rng = np.random.default_rng(0)
    x = (rng.random(12208) * (rng.random(12208) < 0.3)).astype(np.float32)
    xc = torch.from_numpy(x).to(cuda)
    for k in (10.0, 200.0, 3000.0, 1e9):
        n0 = _lib.LAUNCHES["theta_stats"]
        theta = ops.threshold_bisect(xc, k, 10)
        assert _lib.LAUNCHES["theta_stats"] == n0 + 1
        assert float(theta) == float(ops.threshold_bisect_plain(xc, k, 10))


def _hold_bisect(xc, k, rpb, rounds, fanout) -> bool:
    """The one-launch bisection against the plain steps on the same row:
    one launch; in every round up to the first whose ``recsum·rpb >= k``
    tests differ, thresholds bit for bit and sums to ``rtol=1e-5``; θ* and
    the bracket bit for bit unless such a round exists, and then its
    differing tests lie within ``rtol`` of k.  Returns whether the rounds
    parted (a boundary case)."""
    n0 = _lib.LAUNCHES["theta_stats"]
    lo, hi, trace = ops.bisect_rounds(xc, k, rpb, rounds, fanout)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["theta_stats"] == n0 + 1
    plo, phi, ptrace = ops.bisect_rounds(xc, k, rpb, rounds, fanout, stats=theta_stats_plain)
    assert len(trace) == len(ptrace) == rounds
    for (ths, rs), (pths, prs) in zip(trace, ptrace):
        assert ths.shape == rs.shape == (fanout,)
        assert torch.equal(ths, pths)
        torch.testing.assert_close(rs, prs, rtol=1e-5, atol=0)
        ok = (rs * rpb >= k).cpu().numpy()
        pok = (prs * rpb >= k).cpu().numpy()
        if not np.array_equal(ok, pok):
            for j in np.flatnonzero(ok != pok):
                assert abs(float(prs[j]) * rpb - k) <= 1e-5 * abs(k)
            return True
    assert float(lo) == float(plo) and float(hi) == float(phi)
    return False


@pytest.mark.parametrize("fanout", [1, 10, 16, 33])
@pytest.mark.parametrize("rounds", [1, 3, 5])
@pytest.mark.parametrize("lam", [1, 7, 1025, 12208, 10**6])
def test_one_launch_bisection_matches_the_plain_steps(cuda, lam, rounds, fanout):
    """Across the slice's lengths (10⁶ re-reads its slices from global
    memory), rounds and fanouts (1, and 33 in three groups of registers;
    10 and 33 are where a reciprocal multiply would round differently):
    thresholds and θ* bit for bit, boundary cases counted (none here)."""
    rng = np.random.default_rng(lam + 7 * rounds + fanout)
    x = (rng.random(lam) * (rng.random(lam) < 0.3)).astype(np.float32)
    xc = torch.from_numpy(x).to(cuda)
    total = float(x.astype(np.float64).sum()) * 10
    parted = sum(_hold_bisect(xc, k, 10, rounds, fanout)
                 for k in (1.0, 0.01 * total, 0.3 * total, 0.9 * total, 2 * total + 1))
    assert parted == 0


@pytest.mark.parametrize("case", ["zeros", "unreachable", "k0", "ties_at_one", "empty"])
def test_one_launch_bisection_edge_rows(cuda, case):
    """An all-zero row (θ* = 0), k out of reach (θ* = 0), k = 0 (every
    threshold reaches it), a row of ties at 1.0 and an empty row: each the
    plain steps' result."""
    lam = 0 if case == "empty" else 12208
    x = np.zeros(lam, np.float32)
    if case in ("unreachable", "k0"):
        x = np.random.default_rng(1).random(lam).astype(np.float32)
    if case == "ties_at_one":
        x[::3] = 1.0
    xc = torch.from_numpy(x).to(cuda)
    k = {"unreachable": 1e12, "k0": 0.0}.get(case, 50.0)
    for rounds, fanout in ((3, 16), (5, 33), (1, 1)):
        assert not _hold_bisect(xc, k, 10, rounds, fanout)
        theta = float(ops.threshold_bisect(xc, k, 10, rounds, fanout))
        if case in ("zeros", "unreachable", "empty"):
            assert theta == 0.0


def test_bisection_with_no_rounds_launches_nothing(cuda):
    x = torch.rand(100, device=cuda)
    n0 = _lib.LAUNCHES["theta_stats"]
    lo, hi, trace = ops.bisect_rounds(x, 5.0, 10, rounds=0)
    assert trace == [] and _lib.LAUNCHES["theta_stats"] == n0
    plo, phi, _ = ops.bisect_rounds(x, 5.0, 10, rounds=0, stats=theta_stats_plain)
    assert float(lo) == float(plo) == 0.0 and float(hi) == float(phi)


@pytest.mark.parametrize("op", ["and", "or"])
@pytest.mark.parametrize("excl", ["none", "empty", "unsorted_dups", "all"])
@pytest.mark.parametrize("gamma", [1, 3, 64, 65])
def test_single_combine_with_exclusion_bit_identical(cuda, gamma, excl, op):
    """#1 with the planner's exclusion fused in: γ ≤ 64 ids by value, 65
    through a device copy; exclusion lists empty, unsorted with duplicates
    (and a negative id, counted from the end) and all of λ.  Bit for bit the
    reference's fold followed by ``combined[exclude] = 0.0``, one launch;
    the same ids given on the card give the same bits."""
    lam = 12208
    dens, _ = _combine_inputs(gamma, 1, 1, lam)
    rng = np.random.default_rng(gamma)
    rows = rng.integers(0, 12, gamma).astype(np.int32)
    exclude = {"none": None, "empty": np.zeros(0, np.int64),
               "unsorted_dups": np.concatenate([rng.integers(0, lam, 300), [5, 5, 0, -1]]),
               "all": rng.permutation(lam)}[excl]
    want = density_combine_plain(dens, torch.from_numpy(rows), op).numpy().copy()
    if exclude is not None:
        want[exclude] = 0.0
    dc = dens.to(cuda)
    n0 = _lib.LAUNCHES["density_combine"]
    out = density_combine(dc, torch.from_numpy(rows), op, exclude)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["density_combine"] == n0 + 1
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    assert not np.signbit(out.cpu().numpy()).any()  # +0.0, as the reference writes
    assert torch.equal(density_combine(dc, torch.from_numpy(rows).to(cuda), op, exclude), out)


def test_single_query_plans_on_the_card_equal_the_cpu_plans(cuda):
    """``NeedleTailEngine.plan`` with exclusion lists (unsorted, with
    duplicates) on the card equals the same plan on the CPU, every algo."""
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.data.block_store import build_block_store
    from repro_torch.data.synthetic import make_clustered_table

    t = make_clustered_table(num_records=64_000, num_dims=4, density=0.15, seed=3)
    gpu = NeedleTailEngine(build_block_store(t, 100, device=cuda), device=cuda)
    cpu = NeedleTailEngine(build_block_store(t, 100, device="cpu"), device="cpu")
    rng = np.random.default_rng(3)
    lam = gpu.store.num_blocks
    for preds, k, op in (([(0, 1), (2, 1)], 300, "and"), ([(1, 1), (3, 1)], 2000, "or"),
                         ([(2, 0)], 10, "and")):
        for exclude in (None, rng.integers(0, lam, 40), np.arange(lam)[::-2]):
            for algo in ("threshold", "two_prong", "auto"):
                a, ua = gpu.plan(preds, k, op, algo, exclude)
                b, ub = cpu.plan(preds, k, op, algo, exclude)
                np.testing.assert_array_equal(a, b)
                assert ua == ub


def _wave_inputs(seed: int, q: int, gamma: int, lam: int, excl: str):
    """A mixed AND/OR wave: ``(dens, rm, ops, exclude)`` with -1 padding and
    per-row exclusions ("none", "empty" lists, or lists with repeats and a
    negative id on every other row)."""
    dens, rm = _combine_inputs(seed, q, gamma, lam)
    rng = np.random.default_rng(seed + 100)
    ops = ["or" if b else "and" for b in rng.random(q) < 0.4]
    exclude = None
    if excl == "empty":
        exclude = [np.zeros(0, np.int64)] * q
    elif excl == "lists":
        exclude = [np.concatenate([rng.integers(0, lam, 40), [0, 0, -1]]) if i % 2 == 0
                   else np.zeros(0, np.int64) for i in range(q)]
    return dens, rm, ops, exclude


def _wave_plain(dens, rm, ops, exclude):
    from repro_torch.kernels.density_combine import density_combine_wave_plain, exclusion_csr

    is_or = torch.tensor([o == "or" for o in ops])
    csr = None if exclude is None else torch.from_numpy(exclusion_csr(exclude, dens.shape[1]))
    return density_combine_wave_plain(dens, rm, is_or, csr)


@pytest.mark.parametrize("excl", ["none", "empty", "lists"])
@pytest.mark.parametrize("seed,q,gamma,lam", [(0, 64, 3, 12208), (1, 8, 5, 1001), (2, 3, 1, 37),
                                              (3, 300, 3, 4096), (4, 5, 2, 1)])
def test_wave_combine_kernel_bit_identical_to_plain(cuda, seed, q, gamma, lam, excl):
    """#2 on a mixed AND/OR wave in one launch: λ not a multiple of 4 (1001,
    37, 1: the scalar loads), a table past the ids a launch carries by value
    (300 × 4 int32s, copied to the card), device ids, empty and non-empty
    exclusions; bit for bit the plain version and +0.0 where excluded."""
    from repro_torch.kernels.density_combine import WAVE_BY_VALUE, density_combine_wave

    dens, rm, ops, exclude = _wave_inputs(seed, q, gamma, lam, excl)
    want = _wave_plain(dens, rm, ops, exclude)
    dc = dens.to(cuda)
    assert (q * (gamma + 1) > WAVE_BY_VALUE) == (q == 300)
    n0 = _lib.LAUNCHES["density_combine_batch"]
    out = density_combine_wave(dc, rm, ops, exclude)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["density_combine_batch"] == n0 + 1
    assert torch.equal(out.cpu(), want)
    assert not np.signbit(out.cpu().numpy()).any()
    assert torch.equal(density_combine_wave(dc, rm.to(cuda), ops, exclude), out)
    assert torch.equal(density_combine_wave(dc, rm, ops, exclude), out)  # the same bits again


def test_wave_combine_kernel_on_offset_views(cuda):
    """Densities and output rows that start off a 16-byte boundary (an
    offset view of a larger buffer) take the scalar loads, bit for bit."""
    from repro_torch.kernels.density_combine import density_combine_wave

    dens, rm, ops, exclude = _wave_inputs(5, 16, 3, 4096, "lists")
    want = _wave_plain(dens, rm, ops, exclude)
    buf = torch.zeros(dens.numel() + 1, device=cuda)
    view = buf[1:].view(dens.shape)
    view.copy_(dens.to(cuda))
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    assert torch.equal(density_combine_wave(view, rm, ops, exclude).cpu(), want)
    for op in ("and", "or"):
        assert torch.equal(density_combine_batch(view, rm, op).cpu(),
                           density_combine_batch_plain(dens, rm, op))


@pytest.mark.parametrize("q,lam,T", [(64, 12208, 8), (1, 5000, 16), (3, 7, 1), (8, 1000, 17),
                                     (130, 3052, 40), (5, 0, 4)])
def test_theta_batch_kernel_given_thresholds_any_T(cuda, q, lam, T):
    """#5 with given thresholds, any T in one launch (17 and 40 take two and
    three passes of 16), at cluster widths 8 (Q ≤ 12), 4, 2 and 1 (Q =
    130): counts exact, sums to rtol=1e-5, the same bits every run."""
    rng = np.random.default_rng(q + T)
    x = (rng.random((q, lam)) ** 3).astype(np.float32)
    x[rng.random((q, lam)) < 0.3] = 0.0
    th = np.sort(rng.random((q, T)).astype(np.float32), axis=1)
    th[0] = 0.0
    xc, tc = torch.from_numpy(x).to(cuda), torch.from_numpy(th).to(cuda)
    n0 = _lib.LAUNCHES["theta_stats_batch"]
    counts, recsum = theta_stats_batch(xc, tc)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["theta_stats_batch"] == n0 + (q > 0)
    pc, ps = theta_stats_batch_plain(xc, tc)
    assert torch.equal(counts, pc)
    torch.testing.assert_close(recsum, ps, rtol=1e-5, atol=0)
    assert torch.equal(theta_stats_batch(xc, tc)[1], recsum)


@pytest.mark.parametrize("q,lam", [(64, 12208), (1, 1000), (9, 7), (130, 3052)])
def test_theta_wave_kernel_against_plain(cuda, q, lam):
    """#5's wave round (θ from the cut, then theta_count and expected) on
    masked rows with rows that have no cut: θ and counts exact, expected to
    rtol=1e-5, one launch."""
    from repro_torch.core.threshold import threshold_sort_batch
    from repro_torch.kernels.theta_stats import theta_wave, theta_wave_plain

    rng = np.random.default_rng(q + lam)
    x = (rng.random((q, lam)) ** 3).astype(np.float32)
    x[rng.random((q, lam)) < 0.3] = 0.0
    x[0] = 0.0  # nothing to cut
    xc = torch.from_numpy(x).to(cuda)
    sd = threshold_sort_batch(xc)[1]
    n_sel = torch.from_numpy(rng.integers(0, lam + 1, q).astype(np.int32)).to(cuda)
    n_sel[0] = 0
    n0 = _lib.LAUNCHES["theta_stats_batch"]
    got = theta_wave(xc, sd, n_sel, 8192)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["theta_stats_batch"] == n0 + 1
    want = theta_wave_plain(xc, sd, n_sel, 8192)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    assert float(got[1][0]) == float(got[2][0]) == 0.0


def _bisect_loops(xc, ks, rpb, rounds, fanout):
    """The batched θ-bisection of one rank (the all-reduce of a world of one
    is the identity) on the kernel and on the plain rounds, each round's
    statistics kept."""
    from repro_torch.kernels.theta_stats import (
        bisect_carry, bisect_round_batch, bisect_round_batch_plain,
    )

    out = []
    for fn in (bisect_round_batch, bisect_round_batch_plain):
        c = bisect_carry(xc.shape[0], fanout, xc.device)
        trace = []
        for r in range(rounds):
            c = fn(xc, ks, rpb, c, first=r == 0)
            trace.append(c.stats.clone())
        c = fn(xc, ks, rpb, c, first=rounds == 0, stats=False)
        out.append((c.lo.clone(), c.n_sel.clone(), c.exp.clone(), trace))
    return out


@pytest.mark.parametrize("fanout", [1, 10, 16, 33])
@pytest.mark.parametrize("q,lam", [(64, 3052), (64, 12208), (1, 1000), (5, 7)])
def test_bisect_round_kernel_matches_the_plain_rounds(cuda, q, lam, fanout):
    """#5's sharded bisection round: rounds + 1 launches; every round's
    counts exact and sums to rtol=1e-5 until the rounds' ``recsum·rpb >= k``
    tests part (none here), θ*, the count and the bracket bit for bit, the
    records to rtol (10 and 33 are where a reciprocal multiply would round
    the steps differently; 33 takes three passes of 16)."""
    rng = np.random.default_rng(q + lam + fanout)
    x = (rng.random((q, lam)) * (rng.random((q, lam)) < 0.3)).astype(np.float32)
    total = x.astype(np.float64).sum(axis=1) * 10
    ks = np.where(np.arange(q) % 3 == 0, 2 * total + 1, (0.05 + 0.9 * rng.random(q)) * total)
    xc = torch.from_numpy(x).to(cuda)
    kc = torch.from_numpy(ks.astype(np.float32)).to(cuda)
    n0 = _lib.LAUNCHES["theta_stats_batch"]
    (klo, kn, kexp, kt), (plo, pn, pexp, pt) = _bisect_loops(xc, kc, 10, 3, fanout)
    assert _lib.LAUNCHES["theta_stats_batch"] == n0 + 4
    for a, b in zip(kt, pt):
        assert torch.equal((a[:, fanout:] * 10 >= kc[:, None]), (b[:, fanout:] * 10 >= kc[:, None]))
        assert torch.equal(a[:, :fanout], b[:, :fanout])
        torch.testing.assert_close(a[:, fanout:], b[:, fanout:], rtol=1e-5, atol=0)
    assert torch.equal(klo, plo) and torch.equal(kn, pn)
    torch.testing.assert_close(kexp, pexp, rtol=1e-5, atol=0)
    assert bool((klo[::3] == 0.0).all())  # k out of reach: θ* = 0


def test_sharded_bisection_and_wave_launch_counts(cuda, tmp_path):
    """On a world of one over NCCL: ``sharded_threshold_bisect_batch`` makes
    one #5 launch a round and one more; a device wave of AND and OR
    queries one #2 launch and one #5 launch a planning round; the host
    mirror one #2 launch per combine; θ equal to the plain rounds'."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import multi_query
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.multi_query import BatchQuery
    from repro_torch.core.sharded import sharded_threshold_bisect_batch
    from repro_torch.data.block_store import build_block_store
    from repro_torch.data.synthetic import make_clustered_table

    t = make_clustered_table(num_records=64_000, num_dims=4, density=0.15, seed=2)
    store = build_block_store(t, 100, device=cuda)
    qs = [BatchQuery([(0, 1), (2, 1)], 300), BatchQuery([(0, 1)], 50),
          BatchQuery([(1, 1), (3, 1)], 2000, "or"), BatchQuery([(2, 0)], 10, algo="two_prong")]
    _lib.reset_launches()
    wave = NeedleTailEngine(store, device=cuda).any_k_batch(qs)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["density_combine_batch"] == 1
    assert _lib.LAUNCHES["theta_stats_batch"] == wave.device_transfers
    calls = []
    fn = multi_query._combined_matrix
    multi_query._combined_matrix = lambda *a: (calls.append(1), fn(*a))[1]
    try:
        _lib.reset_launches()
        NeedleTailEngine(store, device=cuda).any_k_batch(qs, device=False)
        torch.cuda.synchronize()
    finally:
        multi_query._combined_matrix = fn
    assert _lib.LAUNCHES["density_combine_batch"] == len(calls) > 0
    rng = np.random.default_rng(0)
    x = (rng.random((8, 2000)) * (rng.random((8, 2000)) < 0.3)).astype(np.float32)
    xc = torch.from_numpy(x).to(cuda)
    ks = torch.full((8,), 300.0, device=cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60),
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        _lib.reset_launches()
        r = sharded_threshold_bisect_batch(xc, ks, 10, dist.group.WORLD)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["theta_stats_batch"] == 4
    finally:
        dist.destroy_process_group()
    plo, pn, _, _ = _bisect_loops(xc, ks, 10, 3, 16)[1]
    assert torch.equal(r.theta, plo) and torch.equal(r.num_selected, pn)


@pytest.mark.parametrize(
    "b,hq,hkv,s,t,causal,win,d,dtype",
    [
        (1, 2, 1, 128, 128, True, None, 64, torch.float32),
        (2, 4, 4, 100, 100, True, None, 112, torch.float32),  # kv padding
        (1, 4, 2, 128, 256, True, None, 128, torch.float32),  # S < T, right-aligned
        # window: in the visible kv tile 0 of q tile 1, rows 64..127 see nothing
        (1, 2, 1, 200, 200, True, 64, 112, torch.float32),
        (1, 2, 2, 64, 192, False, None, 64, torch.float32),  # cross-attention
        (1, 8, 2, 300, 300, True, 128, 120, torch.float32),  # GQA + window
        (1, 2, 1, 1, 77, True, None, 128, torch.float32),  # one decode query
        (2, 4, 2, 129, 129, True, None, 112, torch.bfloat16),
        (1, 4, 1, 256, 256, True, 100, 64, torch.bfloat16),
        (1, 2, 2, 70, 70, True, None, 7, torch.float32),  # D not a multiple of 16
        # every head dim: the whole head up to 256 (gemma3-12b: 240), then
        # column groups of 256 with QKᵀ in chunks of 256
        *[(2, 4, 2, 200, 200, True, None, d, torch.float32)
          for d in (1, 17, 120, 128, 129, 240, 256, 300, 512)],
        *[(1, 4, 2, 130, 300, True, 64, d, torch.float32)
          for d in (1, 17, 120, 128, 129, 240, 256, 300, 512)],
        (1, 16, 8, 300, 300, True, 128, 240, torch.bfloat16),  # gemma3's heads, windowed
        (2, 4, 4, 129, 129, True, None, 300, torch.bfloat16),
        # the edges of the 32-key kv tile: S and T of 31, 32, 33
        *[(1, 4, 2, n, n, True, None, 112, torch.float32) for n in (31, 32, 33)],
        *[(1, 2, 1, n, 96, True, 40, 240, torch.float32) for n in (31, 32, 33)],
        (2, 2, 2, 32, 33, False, None, 64, torch.float32),
        # the edge of the whole-head design: D = 256 holds the head, 257 takes groups
        *[(1, 4, 2, 130, 300, True, w, d, torch.float32) for d in (256, 257)
          for w in (None, 64)],
        (1, 2, 1, 100, 100, True, None, 257, torch.bfloat16),
        # D not a multiple of 4: staged by plain loads
        *[(2, 4, 2, 77, 77, True, w, d, torch.float32) for d in (6, 7) for w in (None, 32)],
        (1, 2, 2, 40, 40, True, None, 6, torch.bfloat16),
        # zamba2-7b's heads (32 of 112) decoding one query, and a prompt of one
        (4, 32, 32, 1, 1895, True, None, 112, torch.float32),
        (4, 32, 32, 1, 1, True, None, 112, torch.float32),
    ],
)
def test_flash_attention_kernel_against_plain(cuda, b, hq, hkv, s, t, causal, win, d, dtype):
    g = torch.Generator().manual_seed(s * 1000 + t + d)
    q = torch.randn((b, hq, s, d), generator=g).to(dtype).to(cuda)
    k = torch.randn((b, hkv, t, d), generator=g).to(dtype).to(cuda)
    v = torch.randn((b, hkv, t, d), generator=g).to(dtype).to(cuda)
    n0 = _lib.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["flash_attention"] == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = attention_plain(q.float(), k.float(), v.float(), causal, win)
    atol, rtol = (2e-3, 2e-3) if dtype == torch.float32 else (1e-4, 2.0**-7)
    torch.testing.assert_close(out.float(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "b,h,s,dh,ds",
    [(1, 2, 128, 64, 16), (2, 3, 2048, 64, 64), (1, 2, 256, 64, 128), (1, 4, 128, 16, 16),
     (2, 1, 384, 32, 32), (4, 112, 1920, 64, 64)],
)
@pytest.mark.parametrize("broadcast", [True, False], ids=["head_stride_0", "contiguous"])
@pytest.mark.parametrize("decay", ["fast", "slow"])
def test_ssd_scan_kernel_against_plain(cuda, b, h, s, dh, ds, broadcast, decay):
    g = torch.Generator().manual_seed(s + dh + ds)
    u = (torch.randn((b, h, s, dh), generator=g) * 0.1).to(cuda)
    if decay == "fast":  # dt·A at the reference's init: ~e^-25 over a chunk
        ld = -torch.nn.functional.softplus(torch.randn((b, h, s), generator=g) - 2.0)
    else:  # ~-1e-3 a step, as trained heads: a chunk keeps ~90% of the carried state
        ld = -torch.randn((b, h, s), generator=g).abs() * 1e-3
    ld = ld.to(cuda)
    if broadcast:  # mamba_block's layout: one [B, S, ds] projection for every head
        bm = torch.randn((b, s, ds), generator=g).to(cuda)[:, None].expand(b, h, s, ds)
        cm = torch.randn((b, s, ds), generator=g).to(cuda)[:, None].expand(b, h, s, ds)
    else:
        bm = (torch.randn((b, h, s, ds), generator=g) * 0.3).to(cuda)
        cm = (torch.randn((b, h, s, ds), generator=g) * 0.3).to(cuda)
    n0 = _lib.LAUNCHES["ssd_scan"]
    y = ssd_scan(u, ld, bm, cm)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["ssd_scan"] == n0 + 1
    torch.testing.assert_close(y, ssd_chunked(u, ld, bm, cm, CHUNK), atol=2e-3, rtol=1e-2)


def _ssd_card_inputs(cuda, b, h, s, dh, ds, seed, slow=True):
    """u, log-decays (slow: ~-1e-3 a step) and [B, S, ds] projections
    broadcast to the heads, as mamba_block hands them over."""
    g = torch.Generator().manual_seed(seed)
    u = (torch.randn((b, h, s, dh), generator=g) * 0.1).to(cuda)
    if slow:
        ld = -torch.randn((b, h, s), generator=g).abs() * 1e-3
    else:
        ld = -torch.nn.functional.softplus(torch.randn((b, h, s), generator=g) - 2.0)
    bm = torch.randn((b, s, ds), generator=g).to(cuda)[:, None].expand(b, h, s, ds)
    cm = torch.randn((b, s, ds), generator=g).to(cuda)[:, None].expand(b, h, s, ds)
    return u, ld.to(cuda), bm, cm


@pytest.mark.parametrize("b,h,s,dh,ds", [(1, 2, 128, 64, 16), (2, 3, 2048, 64, 64),
                                         (1, 2, 256, 64, 128), (1, 4, 384, 16, 24)])
@pytest.mark.parametrize("decay", ["fast", "slow"])
def test_ssd_scan_kernel_returns_the_final_state(cuda, b, h, s, dh, ds, decay):
    """``return_state=True``: y and the state after the last step, both
    against ``ssd_chunked(return_state=True)``, from one launch."""
    args = _ssd_card_inputs(cuda, b, h, s, dh, ds, s + ds, slow=decay == "slow")
    n0 = _lib.LAUNCHES["ssd_scan"]
    y, hfin = ssd_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["ssd_scan"] == n0 + 1
    y_p, h_p = ssd_chunked(*args, CHUNK, return_state=True)
    assert hfin.dtype == torch.float32 and hfin.shape == h_p.shape == (b, h, ds, dh)
    torch.testing.assert_close(y, y_p, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(hfin, h_p, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(ssd_scan(*args), y, atol=0, rtol=0)  # the same kernels


def test_ssd_scan_kernel_carries_state_over_64_chunks(cuda):
    """A sequence of 64 chunks at zamba2-7b's heads ([1, 112, 8192], ds =
    dh = 64) with slow decay: the state pass walks 64 chunks, and the state
    it carries is most of the output."""
    args = _ssd_card_inputs(cuda, 1, 112, 8192, 64, 64, 64)
    y, hfin = ssd_scan(*args, return_state=True)
    y_p, h_p = ssd_chunked(*args, CHUNK, return_state=True)
    torch.testing.assert_close(y, y_p, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(hfin, h_p, atol=2e-3, rtol=1e-2)
    u, ld, bm, cm = args  # the same with the state reset at every chunk
    split = [t.reshape(1, 112 * 64, CHUNK, *t.shape[3:]) for t in (u, ld, bm, cm)]
    alone = ssd_chunked(*split, CHUNK).reshape(u.shape)
    assert float((alone - y_p).abs().max()) > 50 * 2e-3


def test_ssd_scan_kernel_stays_finite_over_a_chunk_of_pad_tokens(cuda):
    """128 identical pad tokens with a log-decay of −1 a step: a chunk's
    decays sum to −128, so exp over L's upper triangle would overflow; the
    kernel forms L only where s <= t and stays finite, equal to the plain
    version (which masks the same way)."""
    g = torch.Generator().manual_seed(5)
    b, h, s, dh, ds = 2, 4, 256, 64, 64
    tok_u = torch.randn((dh,), generator=g) * 0.1
    tok_b, tok_c = torch.randn((ds,), generator=g), torch.randn((ds,), generator=g)
    u = torch.randn((b, h, s, dh), generator=g) * 0.1
    bm, cm = torch.randn((b, s, ds), generator=g), torch.randn((b, s, ds), generator=g)
    u[:, :, :CHUNK], bm[:, :CHUNK], cm[:, :CHUNK] = tok_u, tok_b, tok_c  # left padding
    ld = torch.full((b, h, s), -1.0)
    args = (u.to(cuda), ld.to(cuda), bm.to(cuda)[:, None].expand(b, h, s, ds),
            cm.to(cuda)[:, None].expand(b, h, s, ds))
    y, hfin = ssd_scan(*args, return_state=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hfin).all())
    y_p, h_p = ssd_chunked(*args, CHUNK, return_state=True)
    torch.testing.assert_close(y, y_p, atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(hfin, h_p, atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("dh,ds", [(60, 64), (64, 60), (12, 16), (16, 4), (72, 64), (64, 136)],
                         ids=["dh60", "ds60", "dh12", "ds4", "dh72", "ds136"])
def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda, dh, ds):
    """dh and ds are the MMA's n and k: multiples of 8, dh <= 64, ds <= 128;
    anything else raises rather than runs another path."""
    u, ld, bm, cm = _ssd_card_inputs(cuda, 1, 2, 128, dh, ds, 0)
    n0 = _lib.LAUNCHES["ssd_scan"]
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd_scan(u, ld, bm, cm)
    assert _lib.LAUNCHES["ssd_scan"] == n0


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m", "qwen1.5-4b", "gemma3-12b",
                                  "h2o-danube-3-4b"])
def test_reduced_lm_on_the_card_runs_the_kernels(cuda, arch, monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import decode_step, init_params, prefill

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products, as in the reference
    cfg = reduced(get_config(arch))
    model = init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 200), generator=torch.Generator().manual_seed(0))
    _lib.reset_launches()
    with torch.inference_mode():
        logits = model(toks)
        torch.cuda.synchronize()
        pat = model.pattern
        assert _lib.LAUNCHES["flash_attention"] == sum(c in "GLA" for c in pat)
        assert _lib.LAUNCHES["ssd_scan"] == pat.count("M")
        torch.testing.assert_close(logits, model(toks, impl="plain"), atol=2e-3, rtol=2e-3)
        plain_ssd = []  # prefill takes each Mamba state from #9: no plain SSD runs
        import repro_torch.kernels.ssd_chunk as ssd_mod
        import repro_torch.models.layers as layers_mod

        for mod in (ssd_mod, layers_mod):
            monkeypatch.setattr(mod, "ssd_chunked", lambda *a, **k: plain_ssd.append(1))
        _lib.reset_launches()
        last, cache = prefill(model, toks[:, :199], max_seq=200)
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert plain_ssd == [] and _lib.LAUNCHES["ssd_scan"] == pat.count("M")
        torch.testing.assert_close(last, logits[:, 198], atol=2e-3, rtol=2e-3)
        lg, _ = decode_step(model, cache, toks[:, 199], 199)
        torch.testing.assert_close(lg, logits[:, 199], atol=2e-3, rtol=2e-3)


def test_gemma3_one_cycle_at_full_width_on_the_card(cuda):
    """gemma3-12b at its published widths (d_model 3840, 16 heads of 240, 8
    kv heads, d_ff 15360, vocab 262,144), depth cut to one ``LLLLLG`` cycle:
    the forward launches #8 once per layer and equals ``impl="plain"``; a
    prompt of 1,090 > 1,024 tokens fills five rings and one global cache,
    kernel prefill against plain; then decode steps around the rings, each
    against the forward's logits at that position."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma3-12b"), num_layers=6)
    model = init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 1100), generator=torch.Generator().manual_seed(0))
    plen = 1090
    with torch.inference_mode():
        _lib.reset_launches()
        logits = model(toks)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["flash_attention"] == 6
        torch.testing.assert_close(logits, model(toks, impl="plain"), atol=2e-3, rtol=2e-3)
        last, cache = prefill(model, toks[:, :plen], max_seq=1100)
        last_p, cache_p = prefill(model, toks[:, :plen], impl="plain", max_seq=1100)
        torch.testing.assert_close(last, last_p, atol=2e-3, rtol=2e-3)
        torch.testing.assert_close(last, logits[:, plen - 1], atol=2e-3, rtol=2e-3)
        assert [tuple(c["k"].shape) for c in cache] == [(2, 1024, 8, 240)] * 5 + [(2, 1100, 8, 240)]
        for a, b in zip(cache, cache_p):
            for key in a:
                torch.testing.assert_close(a[key], b[key], atol=2e-3, rtol=2e-3)
        del cache_p
        for pos in range(plen, 1099):
            lg, cache = decode_step(model, cache, toks[:, pos], pos)
            torch.testing.assert_close(lg, logits[:, pos], atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# Predicate trees, FORWARD-OPTIMAL, the §5 aggregate path and the baselines:
# each on-card function against the same call on the CPU.
# ---------------------------------------------------------------------------

def _agg_stores(cuda, n=40_000, rpb=200):
    from repro_torch.data.block_store import build_block_store
    from repro_torch.data.synthetic import make_clustered_table

    t = make_clustered_table(n, num_dims=4, density=0.15, seed=5, correlated_measure=True)
    return t, build_block_store(t, rpb, device="cpu"), build_block_store(t, rpb, device=cuda)


def _trees():
    from repro_torch.core import predicates as tp

    return [tp.Eq(0, 1), tp.In(1, (0, 1)), tp.Range(2, 0, 1),
            tp.And((tp.Eq(0, 1), tp.Not(tp.Eq(3, 0)))),
            tp.Or((tp.And((tp.Eq(0, 1), tp.Eq(1, 1))), tp.Not(tp.In(2, (1,))))),
            tp.Not(tp.Or((tp.Eq(0, 0), tp.Eq(1, 0))))]


def test_predicate_trees_on_the_card_equal_the_cpu(cuda):
    _, cpu, card = _agg_stores(cuda)
    for pred in _trees():
        d = pred.density(card.index)
        assert d.device == card.device
        assert torch.equal(d.cpu(), pred.density(cpu.index))
        assert torch.equal(pred.mask(card.dims).cpu(), pred.mask(cpu.dims))


def test_tree_and_forward_optimal_waves_on_the_card_equal_the_cpu(cuda):
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.multi_query import BatchQuery

    _, cpu, card = _agg_stores(cuda)
    queries = [BatchQuery(p, 300 + 50 * i) for i, p in enumerate(_trees())]
    queries += [BatchQuery([(0, 1), (2, 1)], 200, "and", "forward_optimal"),
                BatchQuery([(1, 1), (3, 1)], 150, "or")]
    for device in (True, False):
        mine = NeedleTailEngine(card, device=cuda).any_k_batch(queries, device=device)
        ref = NeedleTailEngine(cpu, device="cpu").any_k_batch(queries, device=device)
        for m, r in zip(mine.results, ref.results):
            for f in ("record_block", "record_row", "measures", "blocks_fetched"):
                np.testing.assert_array_equal(getattr(m, f), getattr(r, f))
            assert (m.algo, m.plan_rounds) == (r.algo, r.plan_rounds)


def test_forward_optimal_scan_on_the_card_equals_the_cpu(cuda):
    from repro_torch.core.cost_model import make_cost_model
    from repro_torch.core.forward_optimal import forward_optimal_scan

    rng = np.random.default_rng(0)
    x = (rng.random(1500) ** 3).astype(np.float32)
    x[rng.random(1500) < 0.4] = 0.0
    for kind, k in (("hdd", 300), ("ssd", 1000)):
        cm = make_cost_model(kind)
        mine = forward_optimal_scan(torch.from_numpy(x).to(cuda), k, 64, cm)
        ref = forward_optimal_scan(torch.from_numpy(x), k, 64, cm)
        assert torch.equal(mine.opt_table.cpu(), ref.opt_table)


def test_block_partials_on_the_card_equal_the_cpu(cuda):
    """The per-block sums add in numpy's order on either device (the CPU
    tests hold that order against the numpy of the reference's machine)."""
    from repro_torch.core.engine import block_partials

    rng = np.random.default_rng(1)
    for shape in ((7, 8192), (3, 5, 8192), (4, 200), (2, 20000)):
        vals = torch.from_numpy((rng.normal(size=shape) * 50).astype(np.float32))
        mask = torch.from_numpy(rng.random(shape) < 0.4)
        tau, n = block_partials(mask.to(cuda), vals.to(cuda))
        ref_tau, ref_n = block_partials(mask, vals)
        np.testing.assert_array_equal(tau, ref_tau)
        np.testing.assert_array_equal(n, ref_n)


def test_aggregate_online_and_groupby_on_the_card_equal_the_cpu(cuda):
    from repro_torch.core import predicates as tp
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.core.groupby import groupby_any_k
    from repro_torch.core.online_agg import AggregateQuery, run_online_aggregate

    _, cpu, card = _agg_stores(cuda)
    ce, ge = NeedleTailEngine(cpu, device="cpu"), NeedleTailEngine(card, device=cuda)
    for preds in ([(0, 1), (1, 1)], tp.And((tp.Eq(0, 1), tp.Not(tp.Eq(2, 0))))):
        for estimator in ("ht", "ratio"):
            e, qr, plan = ge.aggregate(preds, 0, k=2000, estimator=estimator, seed=3)
            re, rqr, rplan = ce.aggregate(preds, 0, k=2000, estimator=estimator, seed=3)
            assert e == re
            np.testing.assert_array_equal(qr.blocks_fetched, rqr.blocks_fetched)
            np.testing.assert_array_equal(qr.measures, rqr.measures)
        q = AggregateQuery(preds, 0, k=2000, alpha=0.4, seed=5)
        res = run_online_aggregate(ge, q, chunk_blocks=8, max_rounds=6)
        ref = run_online_aggregate(ce, q, chunk_blocks=8, max_rounds=6)
        assert res.stream == ref.stream and res.blocks_fetched == ref.blocks_fetched
    for measure in (None, 0):
        g = groupby_any_k(ge, [(0, 1)], 1, 500, psi=8, measure=measure)
        r = groupby_any_k(ce, [(0, 1)], 1, 500, psi=8, measure=measure)
        for f in ("per_group_counts", "blocks_fetched", "record_block", "record_row",
                  "record_group"):
            np.testing.assert_array_equal(getattr(g, f), getattr(r, f))
        assert g.estimate_stream == r.estimate_stream


def test_baselines_on_the_card_equal_the_cpu(cuda):
    from repro_torch.core import baselines as tb

    t, cpu, card = _agg_stores(cuda)
    dims = card.dims.view(-1, card.dims.shape[-1])[:t.num_records]
    idx = tb.build_bitmap_index(dims, t.cards, device=cuda)
    ref = tb.build_bitmap_index(t.dims, t.cards, device="cpu")
    assert torch.equal(idx.bits.cpu(), ref.bits)
    eidx, eref = tb.build_ewah_index(idx), tb.build_ewah_index(ref)
    for a, b in zip(eidx.streams, eref.streams):
        assert torch.equal(a.cpu(), b)
        assert torch.equal(tb.ewah_decompress(a, idx.bits.shape[1]).cpu(),
                           tb.ewah_decompress(b, idx.bits.shape[1]))
    lossy = tb.build_lossy_bitmap(card.index.densities, card.index.vocab.attr_offsets)
    lref = tb.build_lossy_bitmap(cpu.index.densities, cpu.index.vocab.attr_offsets)
    assert torch.equal(lossy.bits.cpu(), lref.bits)
    for preds, op in (([(0, 1), (1, 1)], "and"), ([(2, 0), (3, 1)], "or")):
        for k in (1, 500, 10 ** 7):
            for got, want in zip(tb.bitmap_scan(idx, preds, k, 200, op),
                                 tb.bitmap_scan(ref, preds, k, 200, op)):
                np.testing.assert_array_equal(got, want)
            for got, want in zip(tb.ewah_scan(eidx, preds, k, 200, op),
                                 tb.ewah_scan(eref, preds, k, 200, op)):
                np.testing.assert_array_equal(got, want)
            for got, want in zip(
                    tb.bitmap_random(idx, preds, k, 200, np.random.default_rng(1), op),
                    tb.bitmap_random(ref, preds, k, 200, np.random.default_rng(1), op)):
                np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tb.lossy_bitmap_scan(lossy, preds, op),
                                      tb.lossy_bitmap_scan(lref, preds, op))
        truth = torch.from_numpy(t.valid_mask(preds, op))
        for got, want in zip(tb.disk_scan(truth.to(cuda), 300, 200),
                             tb.disk_scan(truth, 300, 200)):
            np.testing.assert_array_equal(got, want)
