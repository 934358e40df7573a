"""Richer predicate algebra over DensityMaps (paper §2/§3.2).

Counterpart of ``repro/core/predicates.py``, the predicate-to-density
compiler:

  Eq(attr, v)               d = D[attr=v]
  In(attr, {v1..vm})        d = min(Σ_j D[attr=vj], 1)      (disjoint values)
  Range(attr, lo, hi)       = In(attr, lo..hi)              (ordinal dims)
  And(p1..pγ)               d = Π d_i   (independence assumption, §3.2)
  Or(p1..pγ)                d = min(Σ d_i, 1)               (upper bound)
  Not(p)                    d = clip(1 − d_p, 0, 1)

Every node also compiles to an exact row-level mask for the fetched blocks,
so the engine's filter step stays exact while planning stays approximate.

Densities are compiled on the index's device and equal the reference's f32
bits: ``In`` is the ⊕-combine of its rows under OR (one launch of the
``density_combine`` kernel on CUDA: a left fold of single adds, clipped to
1 after the last row, which is what numpy's ``dens[rows].sum(axis=0)``
computes), ``And`` multiplies and ``Or`` adds its parts left to right, each
step one f32 operation.  No step reduces a stacked ``[m, λ]`` tensor with
``torch.sum`` / ``torch.prod``, whose CUDA order is not a left fold.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.density_map import OR, combine_densities


class Predicate:
    def density(self, index) -> torch.Tensor:
        """``[λ]`` f32 on ``index.densities``' device; reads only
        ``index.densities`` and ``index.vocab``."""
        raise NotImplementedError

    def mask(self, block_dims: torch.Tensor) -> torch.Tensor:
        """``[..., R]`` bool on ``block_dims``' device."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Eq(Predicate):
    attr: int
    value: int

    def density(self, index):
        return index.densities[index.vocab.row(self.attr, self.value)].clone()

    def mask(self, block_dims):
        return block_dims[..., self.attr] == self.value


@dataclasses.dataclass(frozen=True)
class In(Predicate):
    attr: int
    values: tuple[int, ...]

    def density(self, index):
        rows = [index.vocab.row(self.attr, v) for v in self.values]
        return combine_densities(index.densities, rows, OR)  # disjoint values

    def mask(self, block_dims):
        values = torch.as_tensor(self.values, dtype=block_dims.dtype, device=block_dims.device)
        return torch.isin(block_dims[..., self.attr], values)


def Range(attr: int, lo: int, hi: int) -> In:
    """Inclusive ordinal range lo..hi."""
    return In(attr, tuple(range(lo, hi + 1)))


@dataclasses.dataclass(frozen=True)
class And(Predicate):
    parts: tuple[Predicate, ...]

    def density(self, index):
        d = self.parts[0].density(index)
        for p in self.parts[1:]:
            d = d * p.density(index)
        return d

    def mask(self, block_dims):
        m = self.parts[0].mask(block_dims)
        for p in self.parts[1:]:
            m = m & p.mask(block_dims)
        return m


@dataclasses.dataclass(frozen=True)
class Or(Predicate):
    parts: tuple[Predicate, ...]

    def density(self, index):
        d = self.parts[0].density(index)
        for p in self.parts[1:]:
            d = d + p.density(index)
        return d.clamp(max=1.0)

    def mask(self, block_dims):
        m = self.parts[0].mask(block_dims)
        for p in self.parts[1:]:
            m = m | p.mask(block_dims)
        return m


@dataclasses.dataclass(frozen=True)
class Not(Predicate):
    part: Predicate

    def density(self, index):
        return (1.0 - self.part.density(index)).clamp(0.0, 1.0)

    def mask(self, block_dims):
        return ~self.part.mask(block_dims)


def from_pairs(pairs: Sequence[tuple[int, int]], op: str = "and") -> Predicate:
    """Adapter from the engine's legacy [(attr, value), ...] form."""
    parts = tuple(Eq(a, v) for a, v in pairs)
    if len(parts) == 1:
        return parts[0]
    return And(parts) if op == "and" else Or(parts)
