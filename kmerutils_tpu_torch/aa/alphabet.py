"""Amino-acid alphabet: 20 residues on 5 bits (numpy, host side).

Port of kmerutils_tpu/aa/alphabet.py, the same code assignment:
lexicographic from 1, except that Q takes 15 (code 14 is skipped).
Anything else encodes to 0xFF.
"""

from __future__ import annotations

import numpy as np

BASES = b"ACDEFGHIKLMNPQRSTVWY"

_CODES = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15, 16, 17, 18, 19, 20, 21]

ENCODE_AA = np.full(256, 0xFF, dtype=np.uint8)
DECODE_AA = np.full(32, ord("?"), dtype=np.uint8)
for _b, _c in zip(BASES, _CODES):
    ENCODE_AA[_b] = _c
    DECODE_AA[_c] = _b

NB_BITS = 5


def is_valid_aa(ascii_bytes) -> np.ndarray:
    return ENCODE_AA[np.asarray(ascii_bytes, dtype=np.uint8)] != 0xFF


def encode_aa(ascii_bytes) -> np.ndarray:
    return ENCODE_AA[np.asarray(ascii_bytes, dtype=np.uint8)]


def decode_aa(codes) -> np.ndarray:
    return DECODE_AA[np.asarray(codes, dtype=np.uint8) & 0x1F]
