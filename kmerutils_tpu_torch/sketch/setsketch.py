"""SetSketch (Ertl 2021): mergeable integer-register signatures (HLL).

Port of kmerutils_tpu/sketch/setsketch.py.  Register i of a read is
max over its items d of clamp(1 + floor(log_b(a / E(d, i))), 0, q), E an
exponential draw that is a pure function of (d, i).  The value is monotone
in the draw's u32 hash, so the maximum runs on the hash alone: the grid
kernel G2 (ops/sketch_grid.py::grid_max) on the card, its plain version on
the CPU; the float32 epilogue (-log, log, floor, clip) then runs once per
register on [n, m].  Registers are carried as int32; the u16 of the
default parameters (:attr:`SetSketchParams.register_dtype`) is the dump's
type only.  Sketches merge by elementwise max; cardinality (Ertl's
estimator, float64) and Jaccard (inclusion-exclusion through the merged
sketch) follow.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import sketch_grid
from ..ops.bitops import M32, shr64
from ..ops.rng import mix2_64
from .probminhash import _fold32


@dataclasses.dataclass(frozen=True)
class SetSketchParams:
    """b, a and q of the register law; m registers."""
    b: float = 1.001
    a: float = 20.0
    q: int = 65534        # fits u16 with one spare value
    m: int = 4096

    @property
    def register_dtype(self):
        """numpy dtype of the registers in a dump."""
        if self.q <= 0xFFFE:
            return np.uint16
        if self.q <= 0xFFFFFFFE:
            return np.uint32
        return np.uint64


def register_salts(m: int, seed: int, device) -> torch.Tensor:
    """Per-register salts, int32[m] (u32 bit patterns): the top half of
    mix2_64(i, 2 * seed + 1)."""
    i = torch.arange(m, dtype=torch.int64, device=device)
    return shr64(mix2_64(i, 2 * seed + 1), 32).to(torch.int32)


def grid_max_args(items: torch.Tensor, valid: torch.Tensor, m: int,
                  seed: int = 0):
    """The inputs of G2 (ops/sketch_grid.grid_max): the items' 32-bit
    folds, valid and the register salts."""
    return (_fold32(items).contiguous(), valid.contiguous(),
            register_salts(m, seed, items.device))


def prefloor(h_best: torch.Tensor, params: SetSketchParams) -> torch.Tensor:
    """The float32 value whose floor plus one is the register, from the
    largest hash per register (u32 bit patterns in int32 or u32 values in
    int64): (ln a - log(-log u)) / ln b, u the hash's top 24 bits as a
    uniform in (0, 1]."""
    h = h_best.to(torch.int64) & M32
    u = (h >> 8).to(torch.float32) * 2.0**-24 + 2.0**-24
    e = -torch.log(u)                                      # Exp(1)
    inv_ln_b = float(np.float32(1.0 / np.log(params.b)))
    ln_a = float(np.float32(np.log(params.a)))
    return (ln_a - torch.log(e)) * inv_ln_b


def registers_from_hashes(h_best: torch.Tensor, empty: torch.Tensor,
                          params: SetSketchParams) -> torch.Tensor:
    """The float32 epilogue: registers int32[n, m] from the largest hash
    per register (u32 bit patterns), 0 for an empty read."""
    val = (1.0 + torch.floor(prefloor(h_best, params))).clamp(
        0.0, float(params.q))
    return torch.where(empty[:, None], 0.0, val).to(torch.int32)


def setsketch_signatures(items: torch.Tensor, valid: torch.Tensor,
                         params: SetSketchParams,
                         seed: int = 0) -> torch.Tensor:
    """Per-read registers int32[n, params.m]; items int32 (u32) or int64
    (u64) [n, P], valid bool[n, P]."""
    h_best = sketch_grid.grid_max(*grid_max_args(items, valid, params.m,
                                                 seed))
    return registers_from_hashes(h_best, ~valid.any(dim=1), params)


def merge(regs_a: torch.Tensor, regs_b: torch.Tensor) -> torch.Tensor:
    """Union of the underlying sets: elementwise max."""
    return torch.maximum(regs_a, regs_b)


def cardinality(regs: torch.Tensor, params: SetSketchParams) -> torch.Tensor:
    """Ertl's cardinality estimate (float64) from registers [..., m]."""
    k = regs.to(torch.float64)
    b = float(params.b)
    s = torch.pow(b, -k).sum(dim=-1)
    return params.m * (1.0 - 1.0 / b) / (float(params.a) * np.log(b)) / s


def jaccard(regs_a: torch.Tensor, regs_b: torch.Tensor,
            params: SetSketchParams) -> torch.Tensor:
    """Jaccard by inclusion-exclusion with the merged (union) sketch."""
    na = cardinality(regs_a, params)
    nb = cardinality(regs_b, params)
    nu = cardinality(merge(regs_a, regs_b), params)
    inter = (na + nb - nu).clamp(min=0.0)
    return torch.where(nu > 0, inter / nu, 0.0)
