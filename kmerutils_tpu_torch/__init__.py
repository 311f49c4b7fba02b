"""kmerutils_tpu_torch — the PyTorch + CUDA port of kmerutils_tpu.

The JAX package ``kmerutils_tpu`` is the reference; this package mirrors its
module paths (``ops/``, ``base/``, ``io/``, ``sketch/``, ``count/``,
``cli/``) so each
module has an obvious counterpart, and it never imports ``jax``.

Conventions:

* every entry point takes an explicit ``device``; a kernel is chosen by the
  device of the tensor it is given (CUDA tensor -> hand-written Hopper kernel
  from ``csrc/``, CPU tensor -> the kernel's plain PyTorch version);
* unsigned values: u32 arithmetic runs on ``int64`` carriers masked to
  32 bits, u64 values live in ``int64`` (multiplies wrap, right shifts are
  masked, ordering uses a sign flip); at a kernel boundary u32 data travels
  as ``int32`` bit patterns.

Ported so far: the datasketcher ProbMinHash (PROB3A) path, from FASTQ to the
signature dump, and whole-file k-mer counting (``parsefastq kmer
--count/--unique``, with its base and read-length statistics).  ROADMAP.md
lists what is still to come.
"""

__version__ = "0.1.0"
