"""The port's interface against the JAX package's, read from the sources.

Both trees are parsed with ``ast``; nothing of either package is imported.
For every module of ``kmerutils_tpu/`` the module of the same path in
``kmerutils_tpu_torch/`` (``ops/merge_pallas.py`` -> ``ops/merge.py``) must
have every public top-level name (function, class, constant), every public
method of a public class (and ``__init__`` / ``__call__``), every
parameter of those, every dataclass field and every argparse flag, or the
name must be in ``NAME_MAP`` with the reason it is not.  An entry of the
map that names something the JAX package no longer has, or that the port
now has, is stale and fails too.  Names only the port has (``--device``,
the plain versions of the kernels, launch counters) are allowed.

Keys of ``NAME_MAP``: ``(module,)`` for a whole module; ``(module, name)``
for a top-level name, or ``(module, "Class.member")``; ``(module,
qualified name, parameter)`` for a parameter (``*args`` / ``**kw`` with
their stars) and ``(module, "argparse", flag)`` for a command-line flag.
An entry covers what lies under it: a function's entry its parameters, a
class's entry its members.  A value that starts with ``"-> "`` names the
port's counterpart (``"-> name: why"``), and that name must exist in the
port's module.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "kmerutils_tpu"
PORT_ROOT = ROOT / "kmerutils_tpu_torch"
RENAMED = {"ops/merge_pallas.py": "ops/merge.py"}

JAX_MODULES = sorted(p.relative_to(JAX_ROOT).as_posix()
                     for p in JAX_ROOT.rglob("*.py"))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _statements(body):
    """Top-level statements, through ``if`` / ``try`` blocks."""
    for st in body:
        if isinstance(st, ast.If):
            yield from _statements(st.body)
            yield from _statements(st.orelse)
        elif isinstance(st, ast.Try):
            yield from _statements(st.body)
            for h in st.handlers:
                yield from _statements(h.body)
            yield from _statements(st.orelse)
            yield from _statements(st.finalbody)
        else:
            yield st


def _assigned(st) -> list[str]:
    targets = st.targets if isinstance(st, ast.Assign) else [st.target]
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _class_surface(cls: ast.ClassDef, provided: bool) -> set[tuple]:
    """Members ("C.m",) and parameters ("C.m", p) of a class.  The port's
    side (``provided``) also counts private members, class attributes,
    ``self.x`` attributes and, without an explicit ``__init__``, the
    fields as ``__init__`` parameters."""
    out = set()
    fields = []
    has_init = False
    for st in cls.body:
        if isinstance(st, FUNCS):
            has_init |= st.name == "__init__"
            if provided or _public(st.name) or st.name in ("__init__",
                                                           "__call__"):
                q = f"{cls.name}.{st.name}"
                out.add((q,))
                out.update((q, p) for p in _params(st))
            if provided:
                for n in ast.walk(st):
                    if (isinstance(n, ast.Attribute)
                            and isinstance(n.ctx, ast.Store)
                            and isinstance(n.value, ast.Name)
                            and n.value.id == "self"):
                        out.add((f"{cls.name}.{n.attr}",))
        elif isinstance(st, ast.AnnAssign) and isinstance(st.target,
                                                          ast.Name):
            fields.append(st.target.id)
        elif isinstance(st, ast.Assign) and provided:
            out.update((f"{cls.name}.{n}",) for n in _assigned(st))
    out.update((f"{cls.name}.{f}",) for f in fields
               if provided or _public(f))
    if provided and not has_init:
        out.update((f"{cls.name}.__init__", f) for f in fields)
    return out


def surface(src: str, provided: bool = False) -> set[tuple]:
    """The keys (without the module) a module's source defines.  With
    ``provided`` (the port's side) imported names count too, so that a
    re-export stands for its name."""
    tree = ast.parse(src)
    out = set()
    for st in _statements(tree.body):
        if isinstance(st, FUNCS) and _public(st.name):
            out.add((st.name,))
            out.update((st.name, p) for p in _params(st))
        elif isinstance(st, ast.ClassDef) and _public(st.name):
            out.add((st.name,))
            out |= _class_surface(st, provided)
        elif isinstance(st, (ast.Assign, ast.AnnAssign)):
            out.update((n,) for n in _assigned(st) if _public(n))
        elif provided and isinstance(st, (ast.Import, ast.ImportFrom)):
            out.update(((a.asname or a.name).split(".")[0],)
                       for a in st.names)
    for n in ast.walk(tree):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("add_argument", "add_parser")):
            out.update(("argparse", a.value) for a in n.args
                       if isinstance(a, ast.Constant)
                       and isinstance(a.value, str))
    return out


def _covered(key: tuple, mapped: set[tuple]) -> bool:
    """Whether an entry of ``mapped`` (keys without the module) covers
    ``key``: the key itself, its function or class, or its class's
    method."""
    if key in mapped or () in mapped:
        return True
    name = key[0]
    if len(key) > 1 and (name,) in mapped:
        return True
    if name != "argparse" and "." in name:
        cls = name.split(".")[0]
        return (cls,) in mapped
    return False


def audit(module: str, jax_src: str, port_src: str | None,
          name_map: dict) -> tuple[list, list]:
    """(gaps, stale) of one module: the JAX keys the port neither has nor
    maps, and the map's entries for the module that are stale, each with
    why."""
    entries = {k[1:]: v for k, v in name_map.items() if k[0] == module}
    required = surface(jax_src)
    if port_src is None:
        provided = set()
        if () not in entries:
            return [(module, "the whole module")], []
    else:
        provided = surface(port_src, provided=True)
    gaps = sorted((module,) + k for k in required - provided
                  if not _covered(k, set(entries)))
    stale = []
    for k, why in entries.items():
        if k == ():
            if port_src is not None:
                stale.append(((module,), "the port has this module"))
            continue
        if k not in required:
            stale.append(((module,) + k, "the JAX package has no such name"))
        elif k in provided:
            stale.append(((module,) + k, "the port has it"))
        elif _covered(k, set(entries) - {k}):
            stale.append(((module,) + k, "covered by a broader entry"))
        elif why.startswith("-> "):
            target = why[3:].split(":")[0].strip()
            if (target,) not in provided:
                stale.append(((module,) + k,
                              f"the port has no {target!r}"))
    return gaps, stale


# -- the map ---------------------------------------------------------------

# Shared reasons.
DTYPE = ("a jax.numpy dtype alias; the port carries u32 values as int32 bit "
         "patterns or masked int64, and u64 values in int64")
SENTINEL = ("the all-ones sentinel as a numpy scalar; the port writes it "
            "inline (-1 in its int64 / int32 carriers)")
PALLAS = ("a Pallas grid, tile or DMA-window argument; the CUDA kernel "
          "sizes its own tiles")
INTERPRET = ("Pallas interpret mode; a CPU tensor takes the kernel's plain "
             "PyTorch version instead")
ARRS = ("the JAX table's tuple of kernel-native i32 word arrays; the port "
        "passes entries as key, cnt and crd tensors (a run)")
XLA_PROGRAM = ("makes a jitted shard_map program; the port calls "
               "torch.distributed collectives directly")
AXIS = ("the mesh axis name; the port has one process group and one "
        "axis")

NAME_MAP: dict[tuple, str] = {
    ("config.py",): (
        "dropped on purpose: the JAX package's switch between its Pallas "
        "and fused-XLA tournaments; the port picks a kernel by the device "
        "of the tensor it is given"),
    # dtype aliases and sentinels
    **{(m, name): DTYPE for m, name in (
        ("aa/kmeraa.py", "U64"), ("anchor.py", "U64"), ("base/kmer.py", "U32"),
        ("base/kmer.py", "U64"), ("base/nthash.py", "U64"),
        ("count/dispatch.py", "U32"), ("count/dispatch.py", "U64"),
        ("count/exact.py", "U32"), ("count/exact.py", "U64"),
        ("count/filters.py", "I32"), ("count/filters.py", "U64"),
        ("count/stream.py", "I32"), ("count/stream.py", "I64"),
        ("count/stream.py", "U32"), ("count/stream.py", "U64"),
        ("ops/bitops.py", "U32"), ("ops/bitops.py", "U64"),
        ("ops/merge_pallas.py", "I32"), ("ops/merge_pallas.py", "U32"),
        ("ops/rng.py", "U32"), ("ops/rng.py", "U64"),
        ("ops/tournament.py", "F32"), ("ops/tournament.py", "U32"),
        ("parallel/collective.py", "U64"), ("parallel/stream.py", "I32"),
        ("parallel/stream.py", "U32"), ("parallel/stream.py", "U64"),
        ("sketch/block.py", "U64"), ("sketch/densminhash.py", "F32"),
        ("sketch/densminhash.py", "U64"), ("sketch/jaccard.py", "U64"),
        ("sketch/minhash.py", "U64"), ("sketch/probminhash.py", "F32"),
        ("sketch/probminhash.py", "I32"), ("sketch/probminhash.py", "U32"),
        ("sketch/probminhash.py", "U64"), ("sketch/setsketch.py", "F32"),
        ("sketch/setsketch.py", "U64"), ("sketch/superminhash.py", "F64"),
        ("sketch/superminhash.py", "U32"),
        ("sketch/superminhash.py", "U64"))},
    **{(m, name): SENTINEL for m, name in (
        ("count/exact.py", "SENTINEL64"), ("count/stream.py", "SENT32"),
        ("count/stream.py", "SENT64"), ("ops/merge_pallas.py", "SENT32"),
        ("sketch/probminhash.py", "SENTINEL64"))},
    # base/
    ("base/alphabet.py", "complement_2b_jnp"): (
        "-> complement_2b_t: the same function on a torch tensor, on its "
        "device"),
    ("base/sequence.py", "pack_codes", "as_numpy"): (
        "device='cpu' gives host tensors; eager PyTorch needs no numpy "
        "batch"),
    # count/stream.py
    ("count/stream.py", "StreamCountTable.arrs"): ARRS,
    ("count/stream.py", "StreamCountTable.cap"): (
        "-> StreamCountTable.capacity: the same number, as a property"),
    ("count/stream.py", "StreamCountTable.window"): PALLAS,
    ("count/stream.py", "StagedFolder.__init__", "window"): PALLAS,
    ("count/stream.py", "StagedFolder.push", "arrs"): ARRS,
    ("count/stream.py", "StagedFolder.push", "live"): (
        "a run holds only live entries, so it needs no liveness mask"),
    ("count/stream.py", "fold", "batch_arrs"): ARRS,
    ("count/stream.py", "fold", "batch_live"): (
        "a run holds only live entries, so it needs no liveness mask"),
    ("count/stream.py", "batch_entries", "read_num_offset"): (
        "read_indices: each row's read number, since the port's batches "
        "are sorted by length"),
    # hnsw.py
    ("hnsw.py", "Hnsw.__init__", "_handle"): (
        "a private hook of the JAX class's loader; the port's Hnsw.load "
        "sets the handle itself"),
    # io/fastx.py
    ("io/fastx.py", "read_batches", "max_len"): (
        "unused by the JAX function itself"),
    ("io/fastx.py", "read_batches", "quantize"): (
        "always on: the width ladder and row quotas of the JAX default; "
        "its shapes only bound XLA compiles, and the port yields no "
        "padding rows"),
    ("io/fastx.py", "read_batches", "packed"): (
        "the port takes the native parser's packed words whenever the "
        "library is built; the batches are the same either way"),
    ("io/fastx.py", "read_batches", "to_host"): (
        "the port's read_batches always yields host batches; "
        "read_batches_overlapped(device=) moves them"),
    ("io/fastx.py", "read_batches_overlapped", "to_device"): (
        "device=: each batch is copied non_blocking from pinned memory "
        "by the consumer"),
    ("io/fastx.py", "read_batches_overlapped", "upload_group"): (
        "groups device_put calls through a slow host link; the port issues "
        "one non_blocking copy a batch"),
    # ops/merge_pallas.py -> ops/merge.py
    ("ops/merge_pallas.py", "merge_sorted_u32"): (
        "-> merge_sorted: K5 on (key, crd) entries"),
    ("ops/merge_pallas.py", "merge_fold_i32"): (
        "-> merge_fold: K3 on (key, cnt, crd) entries"),
    ("ops/merge_pallas.py", "aggregate_fold_i32"): (
        "-> aggregate_fold: K4 on (key, cnt, crd) entries"),
    ("ops/merge_pallas.py", "aggregate_compact_u32"): (
        "-> aggregate_compact: K6 on (key, cnt, crd) entries"),
    ("ops/merge_pallas.py", "compact_live_u32"): (
        "-> compact_live: K7 on a tuple of arrays"),
    ("ops/merge_pallas.py", "merge_path_partition"): (
        "the merge-path splits run inside the K3/K5 kernels"),
    ("ops/merge_pallas.py", "merge_path_partition_dyn"): (
        "the merge-path splits run inside the K3/K5 kernels"),
    # ops/tournament.py
    ("ops/tournament.py", "BIG"): PALLAS,
    ("ops/tournament.py", "LANES"): PALLAS,
    ("ops/tournament.py", "SUB"): PALLAS,
    ("ops/tournament.py", "weighted_tournament", "interpret"): INTERPRET,
    ("ops/tournament.py", "weighted_tournament", "items32"): (
        "items: the same u32 items as int32 bit patterns"),
    ("ops/tournament.py", "weighted_tournament_u64", "interpret"): INTERPRET,
    # parallel/
    ("parallel/mesh.py", "READS_AXIS"): AXIS,
    ("parallel/mesh.py", "make_mesh", "axis"): AXIS,
    ("parallel/mesh.py", "make_mesh", "n_devices"): (
        "world_size=, with rank= and init_method=: one process a device "
        "in a torch.distributed group"),
    ("parallel/mesh.py", "reads_sharding", "axis"): AXIS,
    ("parallel/stream.py", "make_exchange"): (
        "-> exchange: " + XLA_PROGRAM),
    ("parallel/stream.py", "make_drop_reduce"): (
        "-> drop_reduce: " + XLA_PROGRAM),
    ("parallel/stream.py", "make_hint_reduce"): (
        "-> hint_reduce: " + XLA_PROGRAM),
    ("parallel/stream.py", "make_fold"): (
        "count/stream.fold on the rank's own table; " + XLA_PROGRAM),
    ("parallel/stream.py", "make_merge_runs"): (
        "ops/merge.merge_sorted (K5) on the rank's runs; " + XLA_PROGRAM),
}


def _sources(module: str):
    port = PORT_ROOT / RENAMED.get(module, module)
    return ((JAX_ROOT / module).read_text(),
            port.read_text() if port.exists() else None)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_the_jax_interface(module):
    gaps, stale = audit(module, *_sources(module), NAME_MAP)
    assert not gaps, f"in JAX, not in the port nor NAME_MAP: {gaps}"
    assert not stale, f"stale NAME_MAP entries: {stale}"


def test_name_map_names_jax_modules():
    assert {k[0] for k in NAME_MAP} <= set(JAX_MODULES)
    assert all(isinstance(v, str) and v for v in NAME_MAP.values())


# -- the audit itself, on two small synthetic sources ----------------------

SYN_JAX = """
import argparse
import dataclasses

U32 = 1


def f(a, b=1, *rest, **kw):
    pass


@dataclasses.dataclass
class C:
    x: int
    y: int = 0

    def m(self, z):
        pass


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-k", "--kmer")
    p.add_argument("--spill")
"""

SYN_PORT = """
from .other import U32


def f(a, *rest, **kw):
    pass


class C:
    def __init__(self, x):
        self.x = x
        self.y = 0

    def m(self, z):
        pass


def main():
    p.add_argument("-k", "--kmer")
    p.add_argument("--spill")
    p.add_argument("--device")
"""

M = "syn.py"

SYN_CASES = {
    # an unmapped missing parameter is a gap; its entry closes it
    "missing_parameter": (SYN_PORT, {}, [(M, "f", "b")], []),
    "mapped_parameter": (SYN_PORT, {(M, "f", "b"): "why"}, [], []),
    # a function's entry covers its parameters
    "mapped_function": (SYN_PORT.replace("def f(", "def g("),
                        {(M, "f"): "-> g: renamed"}, [], []),
    # a missing field, method or flag
    "missing_field": (SYN_PORT.replace("self.y = 0", "pass"),
                      {(M, "f", "b"): "why"}, [(M, "C.y")], []),
    "missing_method": (SYN_PORT.replace("def m(", "def n("),
                       {(M, "f", "b"): "why"}, [(M, "C.m"), (M, "C.m", "z")],
                       []),
    "missing_flag": (SYN_PORT.replace('"--spill"', '"--spil"'),
                     {(M, "f", "b"): "why"}, [(M, "argparse", "--spill")],
                     []),
    "missing_module": (None, {}, [(M, "the whole module")], []),
    "mapped_module": (None, {(M,): "why"}, [], []),
    # stale entries: no such JAX name, the port has it, a broader entry
    # covers it, its named counterpart is missing, the module is there
    "stale_no_such_name": (SYN_PORT, {(M, "f", "b"): "why", (M, "g"): "x"},
                           [], [(M, "g")]),
    "stale_port_has_it": (SYN_PORT, {(M, "f", "b"): "why",
                                     (M, "f", "a"): "x"}, [], [(M, "f", "a")]),
    "stale_covered": (SYN_PORT.replace("def f(", "def g("),
                      {(M, "f"): "-> g: renamed", (M, "f", "b"): "x"}, [],
                      [(M, "f", "b")]),
    "stale_counterpart": (SYN_PORT, {(M, "f", "b"): "-> h: renamed"}, [],
                          [(M, "f", "b")]),
    "stale_module": (SYN_PORT, {(M,): "why"}, [], [(M,)]),
}


@pytest.mark.parametrize("case", sorted(SYN_CASES))
def test_audit_on_synthetic_sources(case):
    port, name_map, want_gaps, want_stale = SYN_CASES[case]
    gaps, stale = audit(M, SYN_JAX, port, name_map)
    assert gaps == want_gaps
    assert [k for k, _ in stale] == want_stale
