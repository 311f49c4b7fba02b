"""Least times ("bounds") of the port's kernels on one NVIDIA H100.

A kernel's bound is the larger of two times for the same work:

- bytes: each input read once and each output written once, over the
  card's memory rate (3.35 TB/s, H100 SXM data sheet);
- operations: for the tournament kernels K1/K2, the draws the inputs need
  times the thread instructions one draw costs, over SMs x 128 lanes x the
  SM clock that ``nvidia-smi`` reports as its maximum.  The instructions
  per draw are counted in the SASS of each kernel's own inner loops
  (``cuobjdump -sass``, :func:`tournament_instructions_per_draw`): K2's
  one loop, every draw through logf; K1's rejecting loop (weight 1: the
  hash and its test, on the path that skips the rare passes) and its exact
  loop (the other weights, every draw through logf).  K1's bound takes
  the exact loop's count for the draws its counter says took logf and the
  rejecting loop's for the rest (:func:`k1_instructions`).
  For the grid kernels G1/G2 (csrc/sketch.cu), the integer operations
  that the function needs per (position, slot) pair, counted by hand from
  the function and not from the kernel's code (:data:`G1_OPS_PER_PAIR`,
  :data:`G1_OPS_PER_ROUND`, :data:`G2_OPS_PER_PAIR`; :func:`grid_work`),
  over the same issue rate.  Each step is counted as the fewest Hopper
  instructions that state it: a multiply one IMAD, a two- or three-input
  bitwise step (an xor, an xor and a mask) one LOP3, a shift one SHF, a
  test, a min or a max one instruction, a pack of two disjoint bit fields
  one IMAD.  :func:`grid_instructions_per_pair` counts the kernels' own
  inner loops in their SASS, to say how far the code is from that count,
  and splits them by the pipe they issue to (:func:`pipe_of`): the bound
  takes 128 lanes an SM, but the ALU and FMA pipes have 64 each, so the
  busier of the two sets a kernel's floor (:func:`alu_floor_ms`: G2's
  function alone needs :data:`G2_ALU_OPS_PER_PAIR` ALU instructions a
  pair).

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
ALU_LANES_PER_SM = 64       # the ALU pipe: 4 schedulers x 16 lanes
DRAW_MARKER = "0x9e3779b1"  # the first multiply of mix32: one per draw
# one multiply per (position, slot) pair of the grid kernels: G1's second
# hash multiply, G2's first
PAIR_MARKERS = {"grid_min": 0xC2B2AE3D, "grid_max": 0x9E3779B1}
# integer operations per (position, slot) pair that the grid functions need
# (see the module's docstring for how a step is counted).  G2: ^ salt,
# * 0x9E3779B1, >> 15, ^, * 0x85EBCA77, max.  G1, the slot draw and the
# reduction: ^ slotc, * 0x85EBCA77, >> 13, ^, * 0xC2B2AE3D, >> 16, ^,
# >> nbits, the pack pi << u_bits | u, min; and per round of the keyed
# permutation: * a, (^ b) & mask, >> sh, (^) & mask, and the test x >= m
# that ends the walk (after the last walk round, the clamp to m - 1).
G2_OPS_PER_PAIR = 6
G1_OPS_PER_PAIR = 10
G1_OPS_PER_ROUND = 5
# of G2's 6, those that issue on the ALU pipe: ^ salt, >> 15, ^, max (the
# two multiplies issue on the FMA pipe)
G2_ALU_OPS_PER_PAIR = 4

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


def alu_floor_ms(pairs: int, sms: int = 132,
                 clock_hz: float = 1.98e9) -> float:
    """The time the ALU pipe (64 lanes an SM) takes for the ALU
    instructions of ``pairs`` (position, slot) pairs of G2's function as
    stated, each step one instruction (4 a pair): above :func:`bound`'s
    operation time, which counts all six operations at 128 lanes.  A kernel
    that folds two pairs' maxima into one three-input VIMNMX3 (as nvcc does
    for csrc/sketch.cu) needs 3.5 a pair, so this is not a hard floor."""
    return pairs * G2_ALU_OPS_PER_PAIR / (sms * ALU_LANES_PER_SM
                                          * clock_hz) * 1e3


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


def _spellings(c: int) -> tuple[str, str]:
    """A u32 immediate as SASS may print it: unsigned hex, or the negated
    hex of its signed value."""
    signed = c - (1 << 32) if c >= 1 << 31 else c
    return hex(c), ("-" + hex(-signed)) if signed < 0 else hex(signed)


def _has(rest: str, spellings) -> bool:
    low = rest.lower()
    return any(re.search(re.escape(sp) + r"(?![0-9a-f])", low)
               for sp in spellings)


def _is_draw(op: str, rest: str, marker) -> bool:
    if marker:
        return _has(rest, marker)
    return op.startswith("I2F") and "U32" in op      # float(h >> 8)


# the pipe an instruction issues to on Hopper (sm_90), as counted here:
# integer multiplies and multiply-adds to the FMA pipe (the wide and high
# forms kept apart: they occupy it longer), logic, shifts, adds, compares,
# min/max and selects to the ALU pipe, each 64 lanes an SM; shared and
# global memory to the LSU; the rest (branches, votes, barriers, moves of
# uniform registers) counted as "other"
_ALU_OPS = ("LOP3", "SHF", "IADD3", "ISETP", "IMNMX", "VIMNMX", "VIMNMX3",
            "SEL", "LEA", "PLOP3", "P2R", "R2P", "FLO", "POPC", "BREV",
            "PRMT", "IABS", "MOV", "SGXT", "BMSK", "LOP")
_MEM_OPS = ("LDS", "STS", "ATOMS", "LDG", "STG", "LD", "ST", "ATOM", "RED",
            "LDC", "LDSM")


def pipe_of(op: str) -> str:
    """"fma", "fma_wide" (IMAD.HI / IMAD.WIDE), "alu", "mem" or
    "other"."""
    base = op.split(".")[0]
    if base == "IMAD":
        return "fma_wide" if (".HI" in op or ".WIDE" in op) else "fma"
    if base in _ALU_OPS:
        return "alu"
    if base in _MEM_OPS:
        return "mem"
    return "other"


def _target(rest: str):
    tgt = re.search(r"0x([0-9a-f]+)", rest)
    return int(tgt.group(1), 16) if tgt else None


def straight_path(body):
    """The instructions of a loop body (from its first instruction to its
    branch back) that run when every forward branch inside the body is
    taken: the path that skips each guarded region (a rare record or
    pass; a region the compiler predicates instead stays on it)."""
    at = {a: i for i, (a, _, _) in enumerate(body)}
    out, i = [], 0
    while i < len(body):
        addr, op, rest = body[i]
        out.append(body[i])
        tgt = _target(rest) if op == "BRA" else None
        i = at[tgt] if tgt is not None and addr < tgt and tgt in at \
            else i + 1
    return out


def _loops(insns, marker):
    """(first address, branch-back address, body, draws) of every loop
    that holds draws."""
    loops = []
    for addr, op, rest in insns:
        tgt = _target(rest)
        if op.startswith("BRA") and tgt is not None and tgt < addr:
            body = [i for i in insns if tgt <= i[0] <= addr]
            draws = sum(_is_draw(o, r, marker) for _, o, r in body)
            if draws:
                loops.append((tgt, addr, body, draws))
    return loops


def draw_loops(insns, spellings=(DRAW_MARKER,), fallback: bool = True,
               innermost: bool = True) -> list[dict]:
    """Every loop that holds draws (with ``innermost``, only those that
    hold no other such loop), innermost first: its instruction count, the
    draws one pass makes (instructions with an immediate spelled as one of
    ``spellings``, or with ``fallback``, where the constant sits in a
    register, unsigned int-to-float conversions), their ratio, the loop's
    instructions by pipe (:func:`pipe_of`) per draw, and on its
    :func:`straight_path` the instructions, the draws and the unsigned
    int-to-float conversions (one a draw that takes its logarithm)."""
    marker = spellings if any(_has(r, spellings) for _, _, r in insns) \
        else None
    if marker is None and not fallback:
        raise RuntimeError(f"no immediate {spellings} in the SASS")
    loops = _loops(insns, marker)
    inner = [lp for lp in loops
             if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]
    if not inner:
        raise RuntimeError("no loop with draws found in the SASS")
    out = []
    for lo, hi, body, draws in sorted(inner if innermost else loops,
                                      key=lambda lp: len(lp[2])):
        pipes: dict[str, float] = {}
        for _, op, _ in body:
            pipes[pipe_of(op)] = pipes.get(pipe_of(op), 0) + 1 / draws
        path = straight_path(body)
        out.append({
            "instructions": len(body), "draws": draws,
            "instructions_per_draw": len(body) / draws,
            "pipes_per_draw": pipes, "range": [hex(lo), hex(hi)],
            "straight": len(path),
            "straight_draws": sum(_is_draw(o, r, marker) for _, o, r in path),
            "straight_logs": sum(o.startswith("I2F") and "U32" in o
                                 for _, o, _ in path)})
    return out


def draw_loop(insns, spellings=(DRAW_MARKER,), fallback: bool = True) -> dict:
    """The innermost loop with the most draws (the shorter on a tie), as
    :func:`draw_loops` counts it."""
    return max(draw_loops(insns, spellings, fallback),
               key=lambda r: (r["draws"], -r["instructions"]))


def tournament_instructions_per_draw(lib_path: str) -> dict[str, dict]:
    """Each tournament kernel in the library, by name: draw_loop, and for
    a kernel with a loop that rejects draws before their logarithm (K1),
    "exact" and "reject": the innermost loop whose straight path takes a
    logarithm for each draw (all its instructions over its draws) and the
    innermost loop whose straight path draws and takes none (its straight
    path over its draws there; the passes' region, with its own loop, is
    off that path), and their "exact_per_draw" and "reject_per_draw"."""
    out = {}
    for name, insns in sass_functions(lib_path).items():
        if "tournament_kernel" not in name:
            continue
        marker = _spellings(0x9E3779B1)
        r = dict(draw_loop(insns, marker))
        loops = draw_loops(insns, marker, innermost=False)
        reject = [lp for lp in loops
                  if lp["straight_draws"] and not lp["straight_logs"]]
        exact = [lp for lp in loops
                 if lp["straight_logs"] >= lp["draws"] > 0]
        if reject and exact:
            r["reject"], r["exact"] = reject[0], exact[0]
            r["reject_per_draw"] = reject[0]["straight"] / \
                reject[0]["straight_draws"]
            r["exact_per_draw"] = exact[0]["instructions_per_draw"]
            r.update({k: exact[0][k] for k in ("instructions", "draws",
                                               "instructions_per_draw",
                                               "pipes_per_draw", "range")})
        out[name] = r
    return out


def k1_instructions(needed_draws: int, logf_draws: int, counts: dict) -> float:
    """K1's thread instructions for a call from its SASS counts
    (tournament_instructions_per_draw of the K1 kernel): the draws through
    logf at the exact loop's count, the rest at the rejecting loop's."""
    return (logf_draws * counts["exact_per_draw"]
            + (needed_draws - logf_draws) * counts["reject_per_draw"])


GRID_KERNELS = {"grid_min": "grid_min_kernel", "grid_max": "grid_max_kernel"}


def grid_instructions_per_pair(lib_path: str) -> dict[str, dict]:
    """draw_loop of the grid kernels G1 ("grid_min", ``grid_min_kernel``)
    and G2 ("grid_max", ``grid_max_kernel``), counted per (position, slot)
    pair by their PAIR_MARKERS.  Raises when either kernel is missing."""
    funcs = sass_functions(lib_path)
    out = {}
    for kind, kernel in GRID_KERNELS.items():
        found = [insns for name, insns in funcs.items() if kernel in name]
        if len(found) != 1:
            raise RuntimeError(f"{len(found)} kernels named {kernel} in "
                               f"{lib_path}")
        out[kind] = draw_loop(found[0], _spellings(PAIR_MARKERS[kind]),
                              fallback=False)
    return out


def walk_stats(a, b, valid, m: int, chunk: int = 1 << 24) -> dict:
    """G1's cycle walk over the valid positions (key halves a, b:
    int32[n, P] u32 bit patterns) and the m slots: "rounds", the walk
    rounds after the first encryption that the data needs, summed (a round
    is needed while the value lies outside [0, m), at most WALKS times),
    and "clamped", the pairs still outside [0, m) after WALKS rounds, which
    the clamp to m - 1 ends."""
    import torch

    from .ops.bitops import M32
    from .ops.sketch_grid import WALKS, encrypt_pow2, perm_bits
    nbits = perm_bits(m)
    ka = a[valid].to(torch.int64) & M32
    kb = b[valid].to(torch.int64) & M32
    j = torch.arange(m, dtype=torch.int64, device=a.device)
    rounds = torch.zeros((), dtype=torch.int64, device=a.device)
    clamped = torch.zeros((), dtype=torch.int64, device=a.device)
    step = max(1, chunk // m)
    for p0 in range(0, ka.numel(), step):
        a2, b2 = ka[p0:p0 + step, None], kb[p0:p0 + step, None]
        x = encrypt_pow2(j, a2, b2, nbits)
        for _ in range(WALKS):
            need = x >= m
            rounds += need.sum()
            x = torch.where(need, encrypt_pow2(x, a2, b2, nbits), x)
        clamped += (x >= m).sum()
    return {"rounds": int(rounds), "clamped": int(clamped)}


def grid_work(name: str, args) -> tuple[int, int]:
    """(integer operations, bytes) that G1 ("grid_min", args x, a, b,
    valid, slotc) or G2 ("grid_max", args x, valid, salts) needs: per valid
    (position, slot) pair G2_OPS_PER_PAIR, or G1_OPS_PER_PAIR plus
    G1_OPS_PER_ROUND for the first round of the permutation and for each
    walk round this data needs (:func:`walk_stats`); bytes for the u32
    inputs and the valid byte per position read once and the [n, m] u32
    results written once."""
    valid, m = args[-2], args[-1].numel()
    n, P = valid.shape
    pairs = int(valid.sum()) * m
    nwords = len(args) - 2
    nbytes = n * P * (4 * nwords + 1) + n * m * 4
    if name == "grid_max":
        return pairs * G2_OPS_PER_PAIR, nbytes
    rounds = pairs + walk_stats(args[1], args[2], valid, m)["rounds"]
    return pairs * G1_OPS_PER_PAIR + rounds * G1_OPS_PER_ROUND, nbytes
