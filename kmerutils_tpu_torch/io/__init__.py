"""Host I/O: FASTA/FASTQ ingest (``fastx``), the dump formats (``formats``)
and the native parser's binding (``native``).  Import the submodule needed:
the quality path loads ``native`` without importing torch."""
