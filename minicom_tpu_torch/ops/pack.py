"""2-bit base packing and reverse-complement primitives (host numpy).

Base coding follows the reference (`sketch.c:8-25`, `invert_code_rule`
`kthread_bucket.c:64`): A=0, C=1, G=2, T=3; N (and any non-ACGT byte) = 4.
Packed layout matches `DNA_push` (`breads.h:232-248`): base i occupies bits
[2i, 2i+2) of the byte stream, i.e. little-endian within each byte/word.
Bit packing matches `bit_push`: bit i at position i%8 of byte i//8.
"""

from __future__ import annotations

import numpy as np

_CODE2ASCII = np.full(5, ord("N"), dtype=np.uint8)
_CODE2ASCII[:4] = np.frombuffer(b"ACGT", dtype=np.uint8)


def codes_to_ascii(codes: np.ndarray) -> np.ndarray:
    return _CODE2ASCII[codes]


def revcomp_codes(codes: np.ndarray, axis: int = -1) -> np.ndarray:
    """Reverse complement along ``axis``; N (4) maps to N."""
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    return np.flip(comp, axis=axis)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """[..., L] codes (0..3 only) -> [..., ceil(L/4)] uint8, DNA_push layout."""
    L = codes.shape[-1]
    pad = (-L) % 4
    if pad:
        padding = [(0, 0)] * (codes.ndim - 1) + [(0, pad)]
        codes = np.pad(codes, padding)
    c = codes.reshape(codes.shape[:-1] + (-1, 4)).astype(np.uint16)
    byte = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
    return byte.astype(np.uint8)


def unpack_2bit(packed: np.ndarray, length: int) -> np.ndarray:
    """[..., B] uint8 -> [..., length] codes 0..3."""
    b = packed.astype(np.uint8)
    out = np.stack([(b >> (2 * i)) & 3 for i in range(4)], axis=-1)
    out = out.reshape(packed.shape[:-1] + (-1,))
    return out[..., :length].astype(np.uint8)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[..., n] {0,1} -> [..., ceil(n/8)] uint8, bit_push layout (LSB first)."""
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")


def unpack_bits(packed: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_bits: the first ``length`` bits."""
    return np.unpackbits(packed, axis=-1, bitorder="little")[..., :length]


def pack_2bit_words(codes: np.ndarray) -> np.ndarray:
    """[..., L] codes -> [..., ceil(L/16)] uint32 words (base i at bits 2i%32):
    the layout of the realign Hamming verify (XOR + popcount replaces the
    reference's std::bitset<2*readlen>, `bbhashdict.c:247-254`)."""
    L = codes.shape[-1]
    pad = (-L) % 16
    if pad:
        padding = [(0, 0)] * (codes.ndim - 1) + [(0, pad)]
        codes = np.pad(codes, padding)
    c = codes.reshape(codes.shape[:-1] + (-1, 16)).astype(np.uint32)
    w = np.zeros(c.shape[:-1], dtype=np.uint32)
    for i in range(16):
        w |= c[..., i] << np.uint32(2 * i)
    return w


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def popcount_u32(words: np.ndarray) -> np.ndarray:
    """Elementwise popcount of uint32 array."""
    v = words.view(np.uint8) if words.flags.c_contiguous else words.astype(np.uint32).view(np.uint8)
    return _POP8[v].reshape(words.shape + (4,)).sum(axis=-1, dtype=np.int32)
