"""kmerutils_tpu_torch — the PyTorch + CUDA port of kmerutils_tpu.

The JAX package ``kmerutils_tpu`` is the reference; this package mirrors its
module paths (``ops/``, ``base/``, ``io/``, ``sketch/``, ``count/``,
``quality/``, ``aa/``, ``parallel/``, ``cli/``) so each
module has an obvious counterpart, and it never imports ``jax``.

Conventions:

* every entry point that places data takes a ``device``, ``"cuda"`` unless
  the caller asks for another (the CPU tests pass ``device="cpu"``); a
  kernel is chosen by the device of the tensor it is given (CUDA tensor ->
  hand-written Hopper kernel from ``csrc/``, CPU tensor -> the kernel's
  plain PyTorch version);
* unsigned values: u32 arithmetic runs on ``int64`` carriers masked to
  32 bits, u64 values live in ``int64`` (multiplies wrap, right shifts are
  masked, ordering uses a sign flip); at a kernel boundary u32 data travels
  as ``int32`` bit patterns.

Ported: everything the JAX package does, module for module
(``config.py``, the JAX package's Pallas switch, has no counterpart).
``datasketcher`` for all six sketch families (PROB3A, SUPER, SUPER2,
OPTDENS, REVOPTDENS, HLL; ``sketch/``), with block sketches and the
``ann`` export, and the published sequential algorithms they are held to
(``sketch/golden.py``); the amino-acid k-mers and sketcher (``aa/``);
whole-file k-mer counting (``parsefastq kmer --count/--unique``, with its
base and read-length statistics), its reload (``io/formats.
KmerCountReload``) and one-batch exact counting; the quality store and
server with the third CLI ``qualityloader`` (``quality/``, host code);
bottom-k MinHash and range sketches (``sketch/minhash.py``,
``sketch/seqminhash.py``), anchors and their RESP store (``anchor.py``,
``kvstore.py``); shard dispatch and Bloom filters (``count/``); counting
and sketching over several devices with ``torch.distributed``
(``parallel/``: hash-sharded streaming counts, the all-to-all exchange,
the collective merges); the host value types (``base/sequence.Sequence``
and ``IterSequence``, ``base/kmertypes.py``, ``hashed.py``, ``utils.py``)
and the rest of ``base/`` and ``ops/bitops.py``.  Their CPU tests are
``tests/test_torch_*.py`` (``python -m pytest tests/test_torch_*.py``),
which hold the port to the JAX package on the same seeded inputs.

``KMERUTILS_LOG=debug|info|...`` sets the level of the package logger.
The JAX package's persistent XLA compilation cache has no counterpart:
eager PyTorch compiles nothing per shape, and the CUDA kernels are cached
by ``_build.py`` under ``build/kernels/``.
"""

import logging
import os

_level = os.environ.get("KMERUTILS_LOG")
if _level:
    logging.basicConfig()
    logging.getLogger(__name__).setLevel(_level.upper())

__version__ = "0.1.0"
