"""Small sizes of the cells, at which the CPU runs them in a second."""

SMALL = {"genome_len": 20000,
         "read_len": {"median": 300, "sigma": 0.5, "min": 30, "max": 900}}

# each cell's traffic at a size the CPU runs in a second
TINY = {
    "ont_sketch_k8_resident": {"config": SMALL, "traffic": {
        "pool_reads": 200, "max_batch_bases": 16384, "check_batches": 3}},
}
