"""K-mer counting: the streaming count table and host spill, one-batch exact
counts, shard dispatch and the Bloom / counting Bloom filters."""
