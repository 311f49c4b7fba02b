"""Host-side compressed k-mer value types, bit-exact with the reference's
concrete k-mer structs.

Port of kmerutils_tpu/base/kmertypes.py (pure Python).  The device path
never builds per-k-mer objects (base/kmer.py works on whole batches), but
dump formats, golden tests and interop need the reference's value layouts:

* :class:`Kmer32bit`   — <= 14 bases in a u32, the base count stored in the
  TOP 4 BITS (kmer32bit.rs:22,68-87); push keeps the tag and masks the
  value to 2k bits (:98-113); ordering compares (k, value) (:47-55);
  reverse complement via NOT + bit reversal + adjacent-pair swap + right
  shift (:119-137).
* :class:`Kmer16b32bit` — exactly 16 bases filling a raw u32, no length
  field (kmer16b32bit.rs); ordered on the raw word.
* :class:`Kmer64bit`   — 1..32 bases as (u64 value, u8 nb_base)
  (kmer64bit.rs:24); push masks to 2k bits (:68-80); the reverse
  complement shifts right by 64 - 2k (:83-96); ordered on (k, value).
* :class:`KmerAA32bit` / :class:`KmerAA64bit` — amino-acid k-mers, 5 bits a
  residue (kmeraa.rs:147-397); ``reverse_complement`` raises.

``dump_bytes`` gives each type's binary dump record.
"""

from __future__ import annotations

import struct

import numpy as np

from . import alphabet
from ..aa import alphabet as aa_alphabet

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _revbits(v: int, width: int) -> int:
    out = 0
    for _ in range(width):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


def _revcomp_value(value: int, k: int, width: int) -> int:
    """NOT + reverse_bits + swap adjacent bit pairs + shift right width-2k —
    the Hacker's-Delight symmetry the reference uses (kmer32bit.rs:119-137)."""
    mask = (1 << width) - 1
    rc = (~value) & mask
    rc = _revbits(rc, width)
    half = sum(0x5 << (4 * i) for i in range(width // 4))
    rc = ((rc & half) << 1) | ((rc & (half << 1)) >> 1)
    rc >>= width - 2 * k
    return rc & ((1 << (2 * k)) - 1)


class Kmer32bit:
    """u32 kmer, k <= 14, base count in bits 31..28."""

    __slots__ = ("word",)
    NB_BASE_MAX = 14

    def __init__(self, nb_bases: int = 0, word: int | None = None):
        if word is not None:
            self.word = word & _MASK32
            return
        if nb_bases >= 15:
            raise ValueError("Kmer32bit cannot store more than 14 bases")
        self.word = (nb_bases & 0xF) << 28

    def get_nb_base(self) -> int:
        return (self.word >> 28) & 0xF

    def push(self, base: int) -> "Kmer32bit":
        tag = self.word & 0xF0000000
        value_mask = (1 << (2 * self.get_nb_base())) - 1
        new = ((self.word << 2) & value_mask) | (base & 0b11) | tag
        return Kmer32bit(word=new)

    def reverse_complement(self) -> "Kmer32bit":
        k = self.get_nb_base()
        # the whole word (tag included) goes through the symmetry; the final
        # right shift by 32-2k >= 4 pushes the reversed tag bits out, exactly
        # as in the reference (kmer32bit.rs:119-137)
        rc = _revcomp_value(self.word, k, 32)
        return Kmer32bit(word=(rc & 0x0FFFFFFF) | (self.word & 0xF0000000))

    def get_compressed_value(self) -> int:
        """Value with the nb_base tag cleared (kmer32bit.rs:171-178)."""
        return self.word & 0x0FFFFFFF

    def get_uncompressed_kmer(self) -> bytes:
        k = self.get_nb_base()
        codes = [(self.word >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        return alphabet.decode_2b(np.array(codes, dtype=np.uint8)).tobytes()

    def dump_bytes(self) -> bytes:
        return struct.pack("<I", self.word)

    @staticmethod
    def get_nb_base_max() -> int:
        return 14

    def get_bitsize(self) -> int:
        return 32

    @staticmethod
    def build(val: int, kmer_size: int) -> "Kmer32bit":
        """KmerBuilder::build (kmertraits.rs:50-52): val is the raw value,
        the tag is (re)applied."""
        return Kmer32bit(word=(val & 0x0FFFFFFF) | ((kmer_size & 0xF) << 28))

    @staticmethod
    def from_str(s: str) -> "Kmer32bit":
        if len(s) > 14:
            raise ValueError("too long kmer")
        km = Kmer32bit(len(s))
        for c in s.encode():
            code = int(alphabet.ENCODE_2B[c])
            if code == 0xFF:
                raise ValueError("char not in ACGT")
            km = km.push(code)
        return km

    def __str__(self) -> str:
        return self.get_uncompressed_kmer().decode()

    def _key(self):
        return (self.word & 0xF0000000, self.word & 0x0FFFFFFF)

    def __eq__(self, other):
        return self._key() == other._key()

    def __lt__(self, other):
        return self._key() < other._key()

    def __le__(self, other):
        return self._key() <= other._key()

    def __hash__(self):
        return hash(self.word)

    def __repr__(self):
        return f"Kmer32bit({self.word:#010x} '{self}')"


class Kmer16b32bit:
    """Exactly 16 bases in a full u32 (kmer16b32bit.rs)."""

    __slots__ = ("word",)
    NB_BASE_MAX = 16

    def __init__(self, word: int = 0):
        self.word = word & _MASK32

    def get_nb_base(self) -> int:
        return 16

    def push(self, base: int) -> "Kmer16b32bit":
        return Kmer16b32bit(((self.word << 2) | (base & 0b11)) & _MASK32)

    def reverse_complement(self) -> "Kmer16b32bit":
        return Kmer16b32bit(_revcomp_value(self.word, 16, 32))

    def get_compressed_value(self) -> int:
        return self.word

    def get_uncompressed_kmer(self) -> bytes:
        codes = [(self.word >> (2 * (15 - i))) & 3 for i in range(16)]
        return alphabet.decode_2b(np.array(codes, dtype=np.uint8)).tobytes()

    def dump_bytes(self) -> bytes:
        return struct.pack("<I", self.word)

    @staticmethod
    def get_nb_base_max() -> int:
        return 16

    def get_bitsize(self) -> int:
        return 32

    @staticmethod
    def build(val: int, kmer_size: int = 16) -> "Kmer16b32bit":
        if kmer_size != 16:
            raise ValueError("Kmer16b32bit holds exactly 16 bases")
        return Kmer16b32bit(val)

    @staticmethod
    def from_str(s: str) -> "Kmer16b32bit":
        if len(s) != 16:
            raise ValueError("Kmer16b32bit needs exactly 16 bases")
        km = Kmer16b32bit(0)
        for c in s.encode():
            code = int(alphabet.ENCODE_2B[c])
            if code == 0xFF:
                raise ValueError("char not in ACGT")
            km = km.push(code)
        return km

    def __str__(self) -> str:
        return self.get_uncompressed_kmer().decode()

    def __eq__(self, other):
        return self.word == other.word

    def __lt__(self, other):
        return self.word < other.word

    def __le__(self, other):
        return self.word <= other.word

    def __hash__(self):
        return hash(self.word)

    def __repr__(self):
        return f"Kmer16b32bit({self.word:#010x} '{self}')"


class Kmer64bit:
    """(u64 value, u8 nb_base) kmer, 1..32 bases (kmer64bit.rs:24)."""

    __slots__ = ("value", "nb_base")
    NB_BASE_MAX = 32

    def __init__(self, nb_base: int = 0, value: int = 0):
        self.value = value & _MASK64
        self.nb_base = nb_base

    def get_nb_base(self) -> int:
        return self.nb_base

    def push(self, base: int) -> "Kmer64bit":
        value_mask = (1 << (2 * self.nb_base)) - 1
        return Kmer64bit(self.nb_base,
                         ((self.value << 2) & value_mask) | (base & 0b11))

    def reverse_complement(self) -> "Kmer64bit":
        return Kmer64bit(self.nb_base,
                         _revcomp_value(self.value, self.nb_base, 64))

    def get_compressed_value(self) -> int:
        return self.value

    def get_uncompressed_kmer(self) -> bytes:
        k = self.nb_base
        codes = [(self.value >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        return alphabet.decode_2b(np.array(codes, dtype=np.uint8)).tobytes()

    def dump_bytes(self) -> bytes:
        """u8 nb_base then u64 value (kmer64bit.rs dump)."""
        return struct.pack("<BQ", self.nb_base, self.value)

    @staticmethod
    def get_nb_base_max() -> int:
        return 32

    def get_bitsize(self) -> int:
        return 64

    @staticmethod
    def build(val: int, kmer_size: int) -> "Kmer64bit":
        return Kmer64bit(kmer_size, val)

    @staticmethod
    def from_str(s: str) -> "Kmer64bit":
        if len(s) > 32:
            raise ValueError("too long kmer")
        km = Kmer64bit(len(s))
        for c in s.encode():
            code = int(alphabet.ENCODE_2B[c])
            if code == 0xFF:
                raise ValueError("char not in ACGT")
            km = km.push(code)
        return km

    def __str__(self) -> str:
        return self.get_uncompressed_kmer().decode()

    def _key(self):
        return (self.nb_base, self.value)

    def __eq__(self, other):
        return self._key() == other._key()

    def __lt__(self, other):
        return self._key() < other._key()

    def __le__(self, other):
        return self._key() <= other._key()

    def __hash__(self):
        return hash((self.nb_base, self.value))

    def __repr__(self):
        return f"Kmer64bit(k={self.nb_base}, {self.value:#x} '{self}')"


class _KmerAA:
    """Shared AA kmer semantics: 5 bits/residue, push with value mask, NO
    reverse complement (kmeraa.rs:171-187,301-317); Ord on (nb_base, value)."""

    __slots__ = ("value", "nb_base")
    WIDTH = 0       # bits of the carrier word
    NB_BITS = 5

    def __init__(self, nb_base: int = 0, value: int = 0):
        if self.NB_BITS * nb_base > self.WIDTH:
            raise ValueError(
                f"{type(self).__name__} holds at most "
                f"{self.WIDTH // self.NB_BITS} residues")
        self.value = value & ((1 << self.WIDTH) - 1)
        self.nb_base = nb_base

    def get_nb_base(self) -> int:
        return self.nb_base

    def push(self, code: int) -> "_KmerAA":
        mask = (1 << (self.NB_BITS * self.nb_base)) - 1
        return type(self)(self.nb_base,
                          ((self.value << self.NB_BITS) & mask) | (code & 0x1F))

    def reverse_complement(self):
        raise NotImplementedError(
            "no reverse complement for amino-acid kmers (kmeraa.rs:185-187)")

    def get_compressed_value(self) -> int:
        return self.value

    def get_uncompressed_kmer(self) -> bytes:
        k = self.nb_base
        codes = [(self.value >> (self.NB_BITS * (k - 1 - i))) & 0x1F
                 for i in range(k)]
        return aa_alphabet.decode_aa(np.array(codes, dtype=np.uint8)).tobytes()

    def get_bitsize(self) -> int:
        return self.WIDTH

    @classmethod
    def build(cls, val: int, kmer_size: int):
        return cls(kmer_size, val)

    @classmethod
    def from_str(cls, s: str):
        km = cls(len(s))
        for c in s.encode():
            code = int(aa_alphabet.ENCODE_AA[c])
            if code == 0xFF:
                raise ValueError("invalid amino acid")
            km = km.push(code)
        return km

    def __str__(self) -> str:
        return self.get_uncompressed_kmer().decode()

    def _key(self):
        return (self.nb_base, self.value)

    def __eq__(self, other):
        return self._key() == other._key()

    def __lt__(self, other):
        return self._key() < other._key()

    def __hash__(self):
        return hash((self.nb_base, self.value))


class KmerAA32bit(_KmerAA):
    """<= 6 residues in a u32 (kmeraa.rs:147-240)."""
    WIDTH = 32

    @staticmethod
    def get_nb_base_max() -> int:
        return 6


class KmerAA64bit(_KmerAA):
    """<= 12 residues in a u64 (kmeraa.rs:270-397)."""
    WIDTH = 64

    @staticmethod
    def get_nb_base_max() -> int:
        return 12


def kmer_type_for(k: int):
    """The reference's type dispatch (bin/parsefastq.rs:214-237): Kmer32bit
    for k <= 14, Kmer16b32bit for exactly 16, Kmer64bit for 17..=32."""
    if k <= 14:
        return Kmer32bit
    if k == 16:
        return Kmer16b32bit
    if 17 <= k <= 32:
        return Kmer64bit
    raise ValueError(f"no reference kmer type for k={k}")
