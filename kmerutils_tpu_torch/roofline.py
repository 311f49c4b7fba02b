"""Least times ("bounds") of the port's kernels on one NVIDIA H100.

A kernel's bound is the larger of two times for the same work:

- bytes: each input read once and each output written once, over the
  card's memory rate (3.35 TB/s, H100 SXM data sheet);
- operations: for the tournament kernels K1/K2, the draws the inputs need
  times the thread instructions one draw costs, over SMs x 128 lanes x the
  SM clock that ``nvidia-smi`` reports as its maximum.  The instructions
  per draw are counted in the SASS of each kernel's inner loop
  (``cuobjdump -sass``); chip_smoke.py takes the fewest of any tournament
  kernel, so every build and mode is held to one figure for the same work.

Used by chip_smoke.py; nothing here runs at import time, and nothing here
is on the port's data path.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

HBM_BYTES_PER_S = 3.35e12
LANES_PER_SM = 128          # 4 schedulers x 32 lanes issue per clock
DRAW_MARKER = "0x9e3779b1"  # the first multiply of mix32: one per draw

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.splitlines()[0]) * 1e6


def issue_ms(instructions: float, sms: int, clock_hz: float) -> float:
    return instructions / (sms * LANES_PER_SM * clock_hz) * 1e3


def bound(bytes_moved: float, instructions: float | None = None,
          sms: int = 132, clock_hz: float = 1.98e9):
    """(bound ms, "bytes" or "operations")."""
    b = bytes_ms(bytes_moved)
    if instructions is None:
        return b, "bytes"
    o = issue_ms(instructions, sms, clock_hz)
    return (o, "operations") if o > b else (b, "bytes")


def tournament_work(x, winv, m: int, wide: bool) -> tuple[int, int]:
    """(draws, bytes) a tournament over draw inputs x and weights winv
    [n, P] needs: draws for the valid positions that do not repeat the
    position before them (same draw input and winv: csrc/tournament.cu
    skips those), times m; bytes for items (both halves when wide) and winv
    read once and the [n, m] winners written once."""
    need = winv > 0
    need[:, 1:] &= ~((x[:, 1:] == x[:, :-1]) & (winv[:, 1:] == winv[:, :-1]))
    n, P = winv.shape
    return (int(need.sum()) * m,
            n * P * (12 if wide else 8) + n * m * (8 if wide else 4))


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(default):
        return default
    raise RuntimeError("cuobjdump not found")


def sass_functions(lib_path: str) -> dict[str, list[tuple[int, str, str]]]:
    """SASS of every kernel in a shared library: name -> [(address,
    opcode, operands)]."""
    text = subprocess.run([_cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs: dict[str, list[tuple[int, str, str]]] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            continue
        mt = _INSN.search(line)
        if mt and cur is not None:
            cur.append((int(mt.group(1), 16), mt.group(2), mt.group(3)))
    return funcs


def _is_draw(op: str, rest: str, marker: bool) -> bool:
    if marker:
        return DRAW_MARKER in rest.lower()
    return op.startswith("I2F") and "U32" in op      # float(h >> 8)


def draw_loop(insns) -> dict:
    """The innermost loop that holds draws: its instruction count, the
    draws one pass makes (multiplies by DRAW_MARKER, or where the constant
    sits in a register, unsigned int-to-float conversions) and their
    ratio."""
    loops = []
    marker = any(DRAW_MARKER in r.lower() for _, _, r in insns)
    for addr, op, rest in insns:
        tgt = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and tgt and int(tgt.group(1), 16) < addr:
            body = [i for i in insns if int(tgt.group(1), 16) <= i[0] <= addr]
            draws = sum(_is_draw(o, r, marker) for _, o, r in body)
            if draws:
                loops.append((int(tgt.group(1), 16), addr, len(body), draws))
    inner = [lp for lp in loops
             if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]
    if not inner:
        raise RuntimeError("no loop with draws found in the SASS")
    lo, hi, n, draws = max(inner, key=lambda lp: (lp[3], -lp[2]))
    return {"instructions": n, "draws": draws,
            "instructions_per_draw": n / draws,
            "range": [hex(lo), hex(hi)]}


def tournament_instructions_per_draw(lib_path: str) -> dict[str, dict]:
    """draw_loop of each tournament kernel in the library, by name."""
    return {name: draw_loop(insns)
            for name, insns in sass_functions(lib_path).items()
            if "tournament" in name and "finish" not in name}
