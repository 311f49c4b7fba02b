"""The benchmark of kmerutils_tpu_torch, the PyTorch and CUDA port.

One run of one cell: ``python3 -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (see run.py).
"""
