"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ in ``src/repro_torch/csrc/*.cu`` with a plain C
interface.  At first use :func:`load` compiles each source with ``nvcc`` for
``sm_90a`` (all sources at once, one process each), links them into one
shared library under ``build/repro_torch/`` at the repository root and opens
it with ``ctypes``.  The library's name carries a hash of the sources and the
flags, so an edited source is rebuilt and an unchanged one is reused.  Any
build or load failure raises: there is no fall back to the plain versions.

Every wrapper bumps :data:`LAUNCHES` where, and only where, it launches its
kernel, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("density_combine.cu", "theta_stats.cu", "block_gather.cu")
# -fmad=false: no multiply-add contraction, so f32 results keep the plain
# versions' rounding; no fast-math flag for the same reason.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {
    "density_combine_batch": 0, "theta_stats_batch": 0, "block_gather": 0,
}

_lib: ctypes.CDLL | None = None
#: seconds the last :func:`load` spent compiling (0.0 when it reused a build)
build_seconds = 0.0

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # (dens, lam, rows, nq, gamma, op_or, out, stream)
    "nt_density_combine_batch": (_P, _I64, _P, _I64, _I64, ctypes.c_int, _P, _P),
    # (x, nq, lam, thetas, T, counts, recsum, stream)
    "nt_theta_stats_batch": (_P, _I64, _I64, _P, _I64, _P, _P, _P),
    # (slab, ids, u, nbytes, out, stream)
    "nt_block_gather": (_P, _P, _I64, _I64, _P, _P),
}


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
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
