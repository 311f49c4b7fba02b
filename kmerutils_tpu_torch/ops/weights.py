"""The weights stage of ProbMinHash (KW): each row sorted, each position's
run length, in one pass.

The JAX package writes this stage as plain array code
(kmerutils_tpu/sketch/probminhash.py: ``jnp.sort`` of each row, then
``_run_multiplicities``' two scans) and XLA fuses it; eager PyTorch runs it
as some twenty passes over [n, P].  This is the port's own kernel for it
(csrc/weights.cu); it replaces no Pallas kernel.

:func:`sort_weights` takes items [n, P] (int32 u32 or int64 u64 bit
patterns) and valid bool[n, P] and gives, per row: the items sorted in
unsigned order with the invalid positions as the all-ones sentinel at the
end (the items' dtype); float32 ``1 / max(w, 1)``, w the run length of the
position's item (at padding, the plain version's own values); and
``is_real`` (s != sentinel; a real item equal to the sentinel is padding).
The device of the inputs picks the implementation: a CUDA tensor launches
the hand-written kernel (built on first use by _build.py), which takes one
block a row of the narrowest tile class that holds P, or, for rows wider
than every class (16,384 positions, at int32 and at int64), its wide
route (csrc/weights_wide.cu: a segmented sort and a galloping run search);
a CPU tensor runs the plain PyTorch version :func:`sort_weights_ref`,
which is also what the kernel is checked against on the card.  Each
launch reads the counter ``sketch.weights_wide`` (``obs.count``): the
positions it handed to the wide route, 0 on the tile route.
"""

from __future__ import annotations

import torch

from .. import obs

# the sign bit of each item dtype: the plain version sorts unsigned items
# as signed ones with it flipped
SIGN = {torch.int32: -(1 << 31), torch.int64: -(1 << 63)}

# calls that launched the kernel (not the plain version)
launches_weights = 0


def _check(items: torch.Tensor, valid: torch.Tensor) -> None:
    if items.dtype not in SIGN:
        raise ValueError(f"items must be int32 (u32) or int64 (u64), "
                         f"got {items.dtype}")
    if items.dim() != 2:
        raise ValueError(f"items must be [n, P], got {list(items.shape)}")
    if valid.dtype != torch.bool or valid.shape != items.shape \
            or valid.device != items.device:
        raise ValueError(
            f"valid: want torch.bool{list(items.shape)} on {items.device}, "
            f"got {valid.dtype}{list(valid.shape)} on {valid.device}")
    if items.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {items.device}")


def sort_weights(items: torch.Tensor, valid: torch.Tensor):
    """KW.  (s, winv float32, is_real bool), each [n, P], of items [n, P]
    and valid bool[n, P]."""
    global launches_weights
    _check(items, valid)
    if items.device.type == "cpu":
        return sort_weights_ref(items, valid)
    from .. import _build
    lib = _build.load()
    n, P = items.shape
    items, valid = items.contiguous(), valid.contiguous()
    dev = items.device
    s = torch.empty_like(items)
    winv = torch.empty((n, P), dtype=torch.float32, device=dev)
    is_real = torch.empty((n, P), dtype=torch.bool, device=dev)
    if n * P == 0:
        return s, winv, is_real
    wide = int(items.dtype == torch.int64)
    nbytes = lib.sort_weights_scratch_bytes(wide, n, P)
    if nbytes < 0:
        raise RuntimeError(f"sort_weights: no scratch size for {n} x {P}")
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    count_wide(n, P, nbytes)
    _build.launch(lib.launch_sort_weights, wide, items.data_ptr(),
                  valid.data_ptr(), s.data_ptr(), winv.data_ptr(),
                  is_real.data_ptr(), n, P,
                  None if scratch is None else scratch.data_ptr(), nbytes,
                  device=dev)
    launches_weights += 1
    return s, winv, is_real


def count_wide(n: int, P: int, scratch_bytes: int) -> None:
    """Counter ``sketch.weights_wide`` of one launch of n rows of P
    positions: n x P when it takes the wide route (the only route that asks
    for scratch), else 0; nothing while ``obs.sink`` is None."""
    obs.count("sketch.weights_wide", n * P if scratch_bytes else 0)


def sort_weights_ref(items: torch.Tensor, valid: torch.Tensor):
    """Plain version of :func:`sort_weights` (same I/O): invalid positions
    become the all-ones sentinel and sort last (unsigned order, via a sign
    flip), then :func:`_run_multiplicities`' two scans."""
    _check(items, valid)
    sign = SIGN[items.dtype]
    s = torch.where(valid, items, -1)              # -1 == all-ones sentinel
    s = torch.sort(s ^ sign, dim=1).values ^ sign
    is_real = s != -1
    w = _run_multiplicities(s, is_real)
    return s, 1.0 / w.clamp(min=1).to(torch.float32), is_real


def _run_multiplicities(sorted_items: torch.Tensor,
                        is_real: torch.Tensor) -> torch.Tensor:
    """Per-position run length of sorted rows via two scans."""
    n, P = sorted_items.shape
    dev = sorted_items.device
    new_run = torch.ones((n, P), dtype=torch.bool, device=dev)
    new_run[:, 1:] = sorted_items[:, 1:] != sorted_items[:, :-1]
    new_run &= is_real
    idx = torch.arange(P, dtype=torch.int64, device=dev).expand(n, P)
    start = torch.cummax(torch.where(new_run, idx, -1), dim=1).values
    # sentinels end the preceding run too, else the last real run would
    # absorb the padding into its length
    nxt = torch.where(new_run | ~is_real, idx, P)
    rev_min = torch.cummin(nxt.flip(1), dim=1).values.flip(1)  # min, q >= p
    next_start = torch.full((n, P), P, dtype=torch.int64, device=dev)
    next_start[:, :-1] = rev_min[:, 1:]                         # min, q > p
    return next_start - start
