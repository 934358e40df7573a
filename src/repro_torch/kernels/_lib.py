"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ in ``src/repro_torch/csrc/*.cu`` with a plain C
interface.  At first use :func:`load` compiles each source with ``nvcc`` for
``sm_90a`` (all sources at once, one process each), links them into one
shared library under ``build/repro_torch/`` at the repository root and opens
it with ``ctypes``.  The library's name carries a hash of the flags and of
every file under ``csrc/`` (headers such as ``tf32x3.cuh`` included), so an
edited source or header is rebuilt and an unchanged set is reused.  Any
build or load failure raises: there is no fall back to the plain versions.

Every wrapper bumps :data:`LAUNCHES` where, and only where, it launches its
kernel, so a run can show that its main path went through the kernels.
Every wrapper is decorated with :func:`no_gradient`: a kernel writes its
output through a raw pointer, so the output carries no ``grad_fn``, and a
tensor input that requires grad under grad mode raises on the CPU and on
the card alike (on the CPU the plain version would differentiate, and a
step tested there would train wrong on the card).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("density_combine.cu", "theta_stats.cu", "block_gather.cu", "window_scan.cu",
           "flash_attention.cu", "ssd_chunk.cu")
# -fmad=false: no multiply-add contraction, so the plan-path kernels' f32
# results keep the plain versions' rounding bit for bit; no fast-math flag
# for the same reason.  One flag set serves every source: the LM kernels
# (flash_attention.cu, ssd_chunk.cu) are held to tolerances, not bits, and
# write their products as explicit fmaf calls, which the flag leaves alone.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {
    "density_combine": 0, "density_combine_batch": 0, "density_combine_batch_sharded": 0,
    "theta_stats": 0,
    "theta_stats_batch": 0, "prefix_sum": 0, "block_gather": 0,
    "flash_attention": 0, "ssd_scan": 0,
}

_lib: ctypes.CDLL | None = None
#: seconds the last :func:`load` spent compiling (0.0 when it reused a build)
build_seconds = 0.0

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # (dens, lam, host rows or None, device rows or None, gamma, excl or None, n_excl,
    #  op_or, out, stream)
    "nt_density_combine_excl": (_P, _I64, _P, _P, _I64, _P, _I64, ctypes.c_int, _P, _P),
    # (dens, lam, host table or None, device table or None, nq, gamma, excl or None,
    #  out, stream)
    "nt_density_combine_wave": (_P, _I64, _P, _P, _I64, _I64, _P, _P, _P),
    # (x, lam, thetas, T, counts, recsum, stream)
    "nt_theta_stats": (_P, _I64, _P, _I64, _P, _P, _P),
    # (x, lam, rounds, fanout, k, rpb, ths, recsum, lohi, stream)
    "nt_theta_bisect": (_P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_float, _P, _P, _P, _P),
    # (x, nq, lam, thetas, T, counts, recsum, stream)
    "nt_theta_stats_batch": (_P, _I64, _I64, _P, _I64, _P, _P, _P),
    # (x, sorted, n_cut, nq, lam, rpb, theta, theta_count, expected, stream)
    "nt_theta_wave": (_P, _P, _P, _I64, _I64, ctypes.c_float, _P, _P, _P, _P),
    # (x, nq, lam, ks, fanout, rpb, hi0, first, stats, lo, hi, n_sel, exp, st, stream)
    "nt_theta_bisect_batch": (_P, _I64, _I64, _P, _I64, ctypes.c_float, ctypes.c_float,
                              ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P),
    # (slab, ids, u, nbytes, out, stream)
    "nt_block_gather": (_P, _P, _I64, _I64, _P, _P),
    # (x, rows, n, out, scratch or None, scratch_stride, stream)
    "nt_prefix_sum": (_P, _I64, _I64, _P, _P, _I64, _P),
    # (q, k, v, o, B, Hq, Hkv, S, T, D, causal, window, scale, bf16, stream)
    "nt_flash_attention": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                           ctypes.c_int, _I64, ctypes.c_float, ctypes.c_int, _P),
    # (u, ld, B, C, y, h_final or None, scratch, decays, B, H, S, dh, ds,
    #  B's batch/head strides, C's, stream)
    "nt_ssd_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                    _I64, _I64, _I64, _P),
}


def _is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def no_gradient(wrapper):
    """Decorate a kernel wrapper: raise ``TypeError`` if a tensor argument
    (or a tensor in a tuple argument) is a DTensor (a kernel takes each
    rank's local tensors: a CPU DTensor must never reach the plain branch
    unnoticed), and, under grad mode, ``RuntimeError`` if one requires
    grad, whichever branch the call would take."""
    name = wrapper.__name__

    @functools.wraps(wrapper)
    def checked(*args, **kwargs):
        for a in (*args, *kwargs.values()):
            for t in a if isinstance(a, tuple) else (a,):
                if _is_dtensor(t):
                    raise TypeError(f"{name}: a DTensor argument; call the kernel on each "
                                    "rank's local tensors (DTensor.to_local())")
        if torch.is_grad_enabled():
            for a in (*args, *kwargs.values()):
                for t in a if isinstance(a, tuple) else (a,):
                    if isinstance(t, torch.Tensor) and t.requires_grad:
                        raise RuntimeError(
                            f"{name}: an input requires grad, and the kernel defines no "
                            "gradient (as the reference's Pallas kernels define no VJP); "
                            "differentiate the plain path (impl='plain') or call under "
                            "torch.no_grad()")
        return wrapper(*args, **kwargs)
    return checked


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _digest() -> str:
    """A hash of the flags and of every file under ``csrc/`` (the sources and
    the headers they include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(path.relative_to(CSRC).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path, nvcc: str) -> None:
    work = target.parent / f"{target.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    objs = [work / f"{Path(s).stem}.o" for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]  # waits for every process
    log = "".join(f"== {s}\n{text}" for s, text in zip(SOURCES, logs))
    (target.parent / "build.log").write_text(log)
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp_so = work / target.name
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp_so), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_so, target)  # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(work, ignore_errors=True)


def load() -> ctypes.CDLL:
    """Open the kernel library, building it first if this source set has no
    build yet.  Raises on any failure."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    target = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if not target.exists():
        nvcc = _nvcc()
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _build(target, nvcc)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in _SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    for fn, argtypes in (("nt_prefix_sum_scratch_floats", [_I64]),
                         ("nt_prefix_sum_smem_max_n", [])):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I64
    _lib = lib
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launched(name: str, rc: int) -> None:
    """Raise if the C launcher reported a CUDA error; else count the launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel-side argument checks shared by the wrappers: every tensor on
    one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
