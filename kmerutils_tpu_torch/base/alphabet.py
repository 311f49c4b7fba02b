"""2-bit DNA codec tables used by ingest (numpy, host side).

Port of the host half of kmerutils_tpu/base/alphabet.py: A=0b00, C=0b01,
G=0b10, T=0b11 (lexicographic order kept; the complement is bitwise NOT);
anything else encodes to 0xFF and makes ingest drop the read.
"""

from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code; invalid -> 0xFF
ENCODE_2B = np.full(256, 0xFF, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ENCODE_2B[_b] = _i
    ENCODE_2B[_b + 32] = _i  # lowercase
DECODE_2B = np.frombuffer(b"ACGT", dtype=np.uint8).copy()


def encode_2b(ascii_bytes) -> np.ndarray:
    """ASCII -> 2-bit codes (0..3); invalid bases map to 0xFF."""
    return ENCODE_2B[np.asarray(ascii_bytes, dtype=np.uint8)]


def decode_2b(codes) -> np.ndarray:
    """2-bit codes -> ASCII."""
    return DECODE_2B[np.asarray(codes, dtype=np.uint8) & 0b11]
