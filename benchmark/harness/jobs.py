"""What the entries share: the base of an entry, and the packing of reads
on the device into the program's batch layout.

An entry (``benchmark/entries/<name>.py``) defines ``Entry``, a subclass
of :class:`Entry`, whose methods the harness calls in this order:
``inputs`` (make the cell's inputs from the seed; nothing of the program),
``setup`` and ``warm`` (the program, on the cell's own paths), ``job(i)``
for each job of the window (returns the clean bases it processed),
``drain`` (wait for work still queued), ``release`` (free the program's
state) and ``check`` (compare what the window's jobs produced with the
plain reference: a list of (name, number, limit), each number correct at
or below its limit).  ``control`` gives the same numbers for the
reference at the next precision below the configuration's, put in the
program's place (``benchmark/control.py``).
"""

from __future__ import annotations

from ..traffic.generate import rung


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx

    def inputs(self) -> None:
        raise NotImplementedError

    def setup(self) -> None:
        pass

    def warm(self) -> None:
        pass

    def job(self, i: int) -> int:
        raise NotImplementedError

    def drain(self) -> None:
        pass

    def release(self) -> None:
        pass

    def check(self) -> list:
        raise NotImplementedError

    def control(self) -> list:
        raise NotImplementedError


def pack(bases, starts, lengths, device):
    """The program's packed words, int32[n, W], of the reads
    ``bases[start : start + length]`` (``bases``: int64 2-bit codes on the
    device): 16 bases a 32-bit word, the first base in the top bits, zero
    padding, W = ceil(width / 16) + 1 for the batch's width rung."""
    import torch
    n = starts.numel()
    W = -(-rung(int(lengths.max())) // 16) + 1
    pos = torch.arange(W * 16, device=device)
    idx = (starts[:, None] + pos[None, :]).clamp(max=bases.numel() - 1)
    codes = torch.where(pos[None, :] < lengths[:, None], bases[idx], 0)
    shifts = 30 - 2 * torch.arange(16, device=device)
    words = (codes.view(n, W, 16).to(torch.int64) << shifts).sum(dim=2)
    return (words - ((words >> 31) << 32)).to(torch.int32)
