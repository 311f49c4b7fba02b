"""ntHash of every k-mer of a read batch, in closed form.

Port of kmerutils_tpu/base/nthash.py.  The rolling recurrence of the
reference has the closed form

    fhash(p) = rotl( XOR_{j=p}^{p+k-1} t_j, (k-1+p) mod 64 ),
    t_j      = rotr(seed[b_j], j mod 64)
    rhash(p) = rotr( XOR_{j=p}^{p+k-1} u_j, p mod 64 ),
    u_j      = rotl(cseed[b_j], j mod 64)

and each window XOR is px[p+k-1] ^ px[p-1] of an inclusive prefix XOR,
here a log-step (Hillis-Steele) scan over the position axis.  Hashes are
u64 bit patterns in int64 tensors, bit-identical to the JAX package's.
"""

from __future__ import annotations

import torch

from ..ops.bitops import flip64, lt_u64, rotl64, rotr64, s64, shr64
from .sequence import ReadBatch

# 64-bit base seeds (the reference's nthash.rs seeds), as u64 values
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456

# the seeds by 2-bit code, as int64 bit patterns
SEEDS_2B = [s64(SEED_A), s64(SEED_C), s64(SEED_G), s64(SEED_T)]
# complement seeds: the same table reversed (A<->T, C<->G)
CSEEDS_2B = SEEDS_2B[::-1]

MULTISHIFT = 27
MULTISEED = 0x90B45D39FB6DA1FA


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR along dim 1."""
    s = 1
    while s < x.shape[1]:
        y = x.clone()
        y[:, s:] ^= x[:, :-s]
        x = y
        s *= 2
    return x


def nthash_kmers(batch: ReadBatch, k: int):
    """Forward, reverse and canonical ntHash of every k-mer of every read.

    Returns (fhash, rhash, canonical, strand uint8, valid bool), each
    [n_reads, P] with P = max(max_len - k + 1, 1); strand is 1 when
    rhash < fhash (unsigned)."""
    codes = batch.codes().to(torch.int64)
    dev = codes.device
    L = codes.shape[1]
    P = max(batch.max_len - k + 1, 1)
    j = torch.arange(L, dtype=torch.int64, device=dev)
    t = rotr64(torch.tensor(SEEDS_2B, device=dev)[codes], j)
    u = rotl64(torch.tensor(CSEEDS_2B, device=dev)[codes], j)

    def window(px):
        lo = torch.zeros_like(px[:, :P])
        lo[:, 1:] = px[:, : P - 1]
        return px[:, k - 1 : k - 1 + P] ^ lo

    p = torch.arange(P, dtype=torch.int64, device=dev)
    fhash = rotl64(window(_prefix_xor(t)), k - 1 + p)
    rhash = rotr64(window(_prefix_xor(u)), p)
    strand = lt_u64(rhash, fhash).to(torch.uint8)
    canonical = flip64(torch.minimum(flip64(fhash), flip64(rhash)))
    valid = p.to(torch.int32)[None, :] + k <= batch.lengths[:, None]
    return fhash, rhash, canonical, strand, valid


def multi_hash(h0: torch.Tensor, k: int, nb_hash: int) -> torch.Tensor:
    """[..., nb_hash] hashes derived from one: hashed[0] = h0, hashed[i] =
    f(h0, i) for i in 1..nb_hash-1 (the reference's MULTISEED/MULTISHIFT
    derivation)."""
    i = torch.arange(1, nb_hash, dtype=torch.int64, device=h0.device)
    tmp = h0[..., None] * (i ^ s64(k * MULTISEED))
    tmp = tmp ^ shr64(tmp, MULTISHIFT)
    return torch.cat([h0[..., None], tmp], dim=-1)


def nthash_kmers_ascii(reads, k: int, device="cuda"):
    """:func:`nthash_kmers` over ASCII reads (the reference's 8-bit seed
    table maps A/C/G/T to the same four seeds)."""
    from .sequence import pack_ascii_reads
    return nthash_kmers(pack_ascii_reads(reads, device=device), k)


# ---------------------------------------------------------------------------
# scalar oracles (host): the hash of one k-mer straight from its definition
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _rotl_int(x: int, r: int) -> int:
    r %= 64
    return ((x << r) | (x >> (64 - r))) & _M64 if r else x


def nthash_init_ref(codes2b) -> int:
    """Forward ntHash (u64 value) of the k-mer given by its 2-bit codes:
    XOR over i of rotl(seed[b_i], k - 1 - i)."""
    k = len(codes2b)
    h = 0
    for i, c in enumerate(codes2b):
        h ^= _rotl_int(SEEDS_2B[int(c)] & _M64, k - 1 - i)
    return h


def nthash_rcomp_init_ref(codes2b) -> int:
    """Reverse-complement ntHash (u64 value): XOR over i of
    rotl(cseed[b_i], i)."""
    h = 0
    for i, c in enumerate(codes2b):
        h ^= _rotl_int(CSEEDS_2B[int(c)] & _M64, i)
    return h
