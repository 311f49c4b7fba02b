"""qualityloader CLI: the quality compression server.

Port of kmerutils_tpu/cli/qualityloader.py, with the same flags and output:

    python -m kmerutils_tpu_torch.cli.qualityloader -f <fastq> [-p port] [-w]
        [--per-read] [--host HOST]

Loads the file's qualities, remaps them to 3 bits, stores them in a wavelet
matrix (``-w`` is accepted for parity: it is the only storage) and serves
them over the TCP protocol of quality/qserver.py, on port 4766 by default
(``-p 0`` takes a free port).  It prints two lines: the number of reads
loaded and the address served.  Host code only: it takes no ``--device``.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="qualityloader")
    p.add_argument("-f", "--file", required=True, dest="filename")
    p.add_argument("-p", "--port", type=int, default=4766)
    p.add_argument("-w", "--wavelet", action="store_true",
                   help="wavelet-matrix storage (default; flag kept for "
                        "parity)")
    p.add_argument("--per-read", action="store_true",
                   help="one wavelet matrix per read instead of the "
                        "batched store")
    p.add_argument("--host", default="127.0.0.1")
    return p


def main(argv=None):
    from ..quality.qserver import QualityServer
    from ..quality.quality import load_quality_store, load_quality_wm

    args = build_parser().parse_args(argv)
    if args.per_read:
        qseqs = load_quality_wm(args.filename)
    else:
        qseqs = load_quality_store(args.filename)
    print(f"loaded {len(qseqs)} quality sequences from {args.filename}",
          flush=True)
    server = QualityServer(qseqs, port=args.port, host=args.host)
    print(f"serving qualities on {args.host}:{server.port}", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
