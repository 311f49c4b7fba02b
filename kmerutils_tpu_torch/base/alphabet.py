"""DNA alphabet codecs (2/4/8-bit): host numpy tables and two torch helpers.

Port of kmerutils_tpu/base/alphabet.py.  The encodings are the reference's:

* 2-bit: A=0b00, C=0b01, G=0b10, T=0b11 (lexicographic order kept; the
  complement is bitwise NOT); anything else encodes to 0xFF and makes
  ingest drop the read;
* 4-bit: A=0b0001, C=0b0010, G=0b0100, T=0b1000, N=0b1111 (Z=0 pads);
* 8-bit: identity.

The tables and codecs are host numpy; :func:`complement_2b_t` and
:func:`base_counts` are torch ops on the device of their input.
"""

from __future__ import annotations

import numpy as np
import torch

# ASCII -> 2-bit code; invalid -> 0xFF
ENCODE_2B = np.full(256, 0xFF, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ENCODE_2B[_b] = _i
    ENCODE_2B[_b + 32] = _i  # lowercase
DECODE_2B = np.frombuffer(b"ACGT", dtype=np.uint8).copy()

ENCODE_4B = np.full(256, 0xFF, dtype=np.uint8)
for _b, _c in zip(b"ACGTNZ", (0b0001, 0b0010, 0b0100, 0b1000, 0b1111, 0b0000)):
    ENCODE_4B[_b] = _c
    if _b != ord("Z"):
        ENCODE_4B[_b + 32] = _c
DECODE_4B = np.full(16, ord("Z"), dtype=np.uint8)
for _b, _c in zip(b"ACGTN", (0b0001, 0b0010, 0b0100, 0b1000, 0b1111)):
    DECODE_4B[_c] = _b

COMPLEMENT_4B = np.zeros(16, dtype=np.uint8)
for _c, _cc in ((0b0001, 0b1000), (0b0010, 0b0100), (0b0100, 0b0010),
                (0b1000, 0b0001), (0b1111, 0b1111)):
    COMPLEMENT_4B[_c] = _cc

IS_ACGT = ENCODE_2B != 0xFF


def is_acgt(ascii_bytes) -> np.ndarray:
    """True where a byte is one of ACGTacgt."""
    return IS_ACGT[np.asarray(ascii_bytes, dtype=np.uint8)]


def count_non_acgt(ascii_bytes) -> int:
    return int((~is_acgt(ascii_bytes)).sum())


def get_ac_from_tg(c: int) -> int:
    """Lower conjugate of a base: T->A, G->C, others unchanged."""
    return {ord("T"): ord("A"), ord("G"): ord("C")}.get(int(c), int(c))


def encode_2b(ascii_bytes) -> np.ndarray:
    """ASCII -> 2-bit codes (0..3); invalid bases map to 0xFF."""
    return ENCODE_2B[np.asarray(ascii_bytes, dtype=np.uint8)]


def decode_2b(codes) -> np.ndarray:
    """2-bit codes -> ASCII."""
    return DECODE_2B[np.asarray(codes, dtype=np.uint8) & 0b11]


def complement_2b(codes) -> np.ndarray:
    """Complement of 2-bit codes: bitwise NOT, kept to 2 bits."""
    return (~np.asarray(codes, dtype=np.uint8)) & 0b11


def encode_4b(ascii_bytes) -> np.ndarray:
    return ENCODE_4B[np.asarray(ascii_bytes, dtype=np.uint8)]


def decode_4b(codes) -> np.ndarray:
    return DECODE_4B[np.asarray(codes, dtype=np.uint8) & 0x0F]


def complement_2b_t(codes: torch.Tensor) -> torch.Tensor:
    """:func:`complement_2b` of an integer tensor, on its device and in its
    dtype (the JAX package's ``complement_2b_jnp``)."""
    return ~codes & 0b11


def base_counts(codes: torch.Tensor, valid_mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Occurrences of each 2-bit code along the last axis: int32[..., 4].
    ``valid_mask`` (bool, the shape of ``codes``) masks padding."""
    one_hot = codes[..., None] == torch.arange(4, dtype=codes.dtype,
                                               device=codes.device)
    if valid_mask is not None:
        one_hot = one_hot & valid_mask[..., None]
    return one_hot.sum(dim=-2, dtype=torch.int32)
