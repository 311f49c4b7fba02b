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

Ported so far: ``datasketcher`` for all six sketch families (PROB3A, SUPER,
SUPER2, OPTDENS, REVOPTDENS, HLL; ``sketch/``), with block sketches and the
``ann`` export; the amino-acid k-mers and sketcher (``aa/``); whole-file
k-mer counting (``parsefastq kmer --count/--unique``, with its base and
read-length statistics) and one-batch exact counting; the quality store and
server with the third CLI ``qualityloader`` (``quality/``, host code);
bottom-k MinHash and range sketches (``sketch/minhash.py``,
``sketch/seqminhash.py``), anchors and their RESP store (``anchor.py``,
``kvstore.py``); shard dispatch and Bloom filters (``count/``); counting
and sketching over several devices with ``torch.distributed``
(``parallel/``: hash-sharded streaming counts, the all-to-all exchange,
the collective merges).  Their CPU
tests are
``tests/test_torch_*.py`` (``python -m pytest tests/test_torch_*.py``),
which hold the port to the JAX package on the same seeded inputs.
ROADMAP.md lists what is still to come.
"""

__version__ = "0.1.0"
