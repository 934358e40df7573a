"""Fault-tolerant checkpointing: atomic, keep-k, auto-resume (counterpart of
``repro/checkpoint/manager.py``).

Layout:
  <dir>/step_<N>/            one directory per step
      meta.json              step, leaf manifest, wall time, ``extra``
      <leaf-hash>.npy        one file per leaf (host numpy)
      _COMMITTED             sentinel written last: a step directory without
                             it is garbage from a crashed save, ignored and
                             removed

Atomicity: write into ``step_<N>.tmp``, fsync, ``os.rename`` (atomic on
POSIX), then the sentinel.  Leaves are named by path: a
:class:`~repro_torch.launch.steps.TrainState` gives ``model.`` plus each
``state_dict`` key, ``opt.m.`` / ``opt.v.`` plus each parameter name,
``opt.step`` and ``step``; a dict or NamedTuple its keys or fields joined
by dots.  bf16 tensors (AdamW moments in bf16) are stored as their int16
bits, the manifest keeping the dtype.

A sharded state (DTensor leaves) is saved as whole arrays: every rank calls
``full_tensor()`` on each leaf in the same order, rank 0 writes and commits,
and the ranks meet at a barrier, so no rank returns before the step is
committed.  ``restore(shardings=)`` loads each whole array and places it on
the mesh the sharding names (``distribute_tensor``, each rank keeping its
shard): the elastic restart, saved on one mesh and restored on another.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn


def _leaf_name(path_str: str) -> str:
    h = hashlib.sha1(path_str.encode()).hexdigest()[:16]
    return f"{h}.npy"


def flatten_state(state: Any, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}`` in a fixed order: an ``nn.Module``'s ``state_dict``
    entries (the parameters themselves), a dict's or NamedTuple's members
    under their keys; anything else is a leaf."""
    if isinstance(state, nn.Module):
        return {prefix + k: v for k, v in state.state_dict(keep_vars=True).items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        items = zip(state._fields, state)
    elif isinstance(state, dict):
        items = state.items()
    else:
        return {prefix.rstrip("."): state}
    out = {}
    for k, v in items:
        out.update(flatten_state(v, f"{prefix}{k}."))
    return out


def _is_dtensor(t) -> bool:
    return hasattr(t, "full_tensor") and hasattr(t, "placements")


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def latest_step(ckpt_dir: str | Path) -> int | None:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.name.startswith("step_") and (p / "_COMMITTED").exists():
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


class CheckpointManager:
    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)
        self._gc_partial()

    def _gc_partial(self):
        for p in self.dir.iterdir():
            if p.name.endswith(".tmp") or (
                p.name.startswith("step_") and not (p / "_COMMITTED").exists()
            ):
                shutil.rmtree(p, ignore_errors=True)

    def save(self, step: int, state: Any, extra: dict | None = None) -> Path:
        final = self.dir / f"step_{step}"
        leaves = flatten_state(state)
        sharded = any(_is_dtensor(v) for v in leaves.values())
        if sharded:  # every rank gathers every leaf, in one order; rank 0 writes
            leaves = {k: v.full_tensor() if _is_dtensor(v) else v for k, v in leaves.items()}
            if torch.distributed.get_rank() != 0:
                torch.distributed.barrier()
                return final
        tmp = self.dir / f"step_{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        manifest = {}
        for pstr, leaf in leaves.items():
            fname = _leaf_name(pstr)
            arr, dtype = _to_numpy(leaf)
            np.save(tmp / fname, arr)
            manifest[pstr] = {"file": fname, "shape": list(arr.shape), "dtype": dtype}
        meta = {
            "step": step,
            "time": time.time(),
            "manifest": manifest,
            "extra": extra or {},
        }
        (tmp / "meta.json").write_text(json.dumps(meta))
        # fsync the directory contents before the atomic publish
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        (final / "_COMMITTED").touch()
        self._cleanup()
        if sharded:
            torch.distributed.barrier()
        return final

    def _cleanup(self):
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.iterdir()
            if p.name.startswith("step_") and (p / "_COMMITTED").exists()
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def extra(self, step: int) -> dict:
        """The ``extra`` dict saved with ``step``."""
        return json.loads((self.dir / f"step_{step}" / "meta.json").read_text())["extra"]

    @torch.no_grad()
    def restore(self, state_like: Any, step: int | None = None, shardings: Any = None
                ) -> tuple[Any, int]:
        """Load ``step`` (default: the newest committed) into a state shaped
        like ``state_like``: an ``nn.Module`` in it is filled in place (it
        holds the weights); every other tensor leaf comes back as a new
        tensor with the dtype and device of its ``state_like`` leaf.  Raises
        ``KeyError`` on a leaf the checkpoint lacks and ``ValueError`` on a
        shape mismatch, before anything is written.

        ``shardings`` mirrors ``state_like`` (a dict of parameter names for
        a module), its leaves ``distributed.sharding.NamedSharding`` or
        ``None``: a leaf with a sharding comes back as a DTensor on its mesh
        with its spec (a module's parameter replaced by one), each rank
        keeping its shard of the whole array; a DTensor leaf without one
        keeps its own mesh and placements; the rest load as above."""
        from repro_torch.distributed.sharding import NamedSharding

        place = flatten_state(shardings) if shardings is not None else {}
        bad = [k for k, v in place.items() if v is not None and not isinstance(v, NamedSharding)]
        if bad:
            raise TypeError(f"shardings leaves must be NamedSharding or None: {bad[:3]}")
        step = step if step is not None else latest_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.dir}")
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "meta.json").read_text())
        loaded = {}
        for pstr, leaf in flatten_state(state_like).items():
            info = meta["manifest"].get(pstr)
            if info is None:
                raise KeyError(f"checkpoint missing leaf {pstr}")
            arr = np.load(d / info["file"])
            t = torch.from_numpy(arr)
            if info["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {pstr}: {tuple(t.shape)} vs "
                                 f"{tuple(leaf.shape)}")
            loaded[pstr] = t
        return _fill(state_like, loaded, place, ""), step


def _placed(t: torch.Tensor, like, sharding):
    """Whole array ``t`` on ``like``'s dtype and device, as a DTensor of
    ``sharding``, or of ``like``'s own placements when ``like`` is one."""
    from repro_torch.distributed.sharding import distribute, spec_of

    t = t.to(dtype=like.dtype, device=like.device)
    if sharding is not None:
        return distribute(t, sharding.mesh, sharding.spec)
    if _is_dtensor(like):
        return distribute(t, like.device_mesh, spec_of(like.placements, like.device_mesh, t.dim()))
    return t


def _fill(like: Any, loaded: dict, place: dict, prefix: str) -> Any:
    if isinstance(like, nn.Module):
        from repro_torch.distributed.sharding import set_parameter

        params = dict(like.named_parameters())
        for k, v in like.state_dict(keep_vars=True).items():
            sharding = place.get(prefix + k)
            if k in params and (sharding is not None or _is_dtensor(v)):
                set_parameter(like, k, _placed(loaded[prefix + k], v, sharding))
            else:
                v.copy_(loaded[prefix + k])
        return like
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_fill(v, loaded, place, f"{prefix}{k}.")
                            for k, v in zip(like._fields, like)))
    if isinstance(like, dict):
        return {k: _fill(v, loaded, place, f"{prefix}{k}.") for k, v in like.items()}
    key = prefix.rstrip(".")
    return _placed(loaded[key], like, place.get(key))
