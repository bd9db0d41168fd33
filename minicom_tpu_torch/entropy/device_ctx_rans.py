"""Order-k context rANS on the device (codecs "trans1", "trans2") and the dz
LZ transform with its residual coded on the device (codec "dzt"). The format
is the JAX package's ``minicom_tpu/entropy/device_ctx_rans.py``, byte for
byte.

Model: static per-block tables conditioned on the previous k symbols over a
remapped alphabet (the used byte values; A symbols). The requested k
degrades until the dense table A^k * A * 2 bytes fits kTableCap; the k used
ships in the header. Lanes own contiguous chunks (lane l codes symbols
[l*T, (l+1)*T)), so each lane's context is the true previous-k window; the
context resets to symbol 0 at chunk starts. The host counts each block's
(context, symbol) pairs and quantizes them (float64 numpy, as the reference
does); the scans run in ``ops/rans.py`` and take the frequency rows as the
header holds them (the kernels build their tables in shared memory; encode
finds each slot's context, frequency and cumulative frequency itself). One
launch codes all blocks of a stream, and one decodes them.

Layout per block (little-endian):
  u8 version=2  u8 log2(LANES)  u8 k  u8 pad
  u16 M (=4096) u16 A           u64 n_symbols
  u8  alphabet[A]               (byte value of each symbol id)
  u16 freq[A^k, A]              (quantized to sum M per used context)
  u32 state[LANES]  u32 words_per_lane[LANES]
  u16 lane streams, concatenated in lane order
"""

from __future__ import annotations

import numpy as np

from minicom_tpu_torch import native
from minicom_tpu_torch.entropy.device_rans import (Block, decode_blocks,
                                                  encode_blocks)
from minicom_tpu_torch.ops.rans import LANES, M

_VERSION = 2
BLOCK = 1 << 22            # symbols per block
kTableCap = 128 << 10      # max dense freq-table bytes per block


def _feasible_k(A: int, k: int) -> int:
    while k > 0 and (A ** k) * A * 2 > kTableCap:
        k -= 1
    return k


def _quantize_rows(cnt: np.ndarray) -> np.ndarray:
    """[C, A] counts -> [C, A] uint16 frequencies, each USED row summing to
    exactly M with every present symbol >= 1 (vectorized largest-remainder;
    unused rows stay zero — decode never gathers them)."""
    C, A = cnt.shape
    tot = cnt.sum(axis=1, keepdims=True)
    used = tot[:, 0] > 0
    q = np.zeros((C, A), np.int64)
    if not used.any():
        return q.astype(np.uint16)
    cu = cnt[used].astype(np.float64)
    tu = cu.sum(axis=1, keepdims=True)
    scaled = cu * M / tu
    qu = np.floor(scaled).astype(np.int64)
    qu[(cu > 0) & (qu == 0)] = 1
    # hand the per-row deficit to the largest remainders (ties: lower symbol)
    deficit = M - qu.sum(axis=1)
    rem = scaled - np.floor(scaled)
    rem[cu == 0] = -1.0
    order = np.argsort(-rem, axis=1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.broadcast_to(np.arange(A),
                                                    order.shape).copy(), 1)
    qu += ranks < deficit[:, None]
    # rows can also overshoot (many forced 1s): take from largest entries
    for _ in range(2):
        over = qu.sum(axis=1) - M
        bad = over > 0
        if not bad.any():
            break
        rows = np.flatnonzero(bad)
        for r in rows:     # rare: rows with > M/2 forced-present symbols
            need = int(over[r])
            while need > 0:
                i = int(np.argmax(qu[r]))
                take = min(need, int(qu[r, i]) - 1)
                if take <= 0:
                    raise ValueError("cannot quantize: too many symbols")
                qu[r, i] -= take
                need -= take
    q[used] = qu
    return q.astype(np.uint16)


def _tier_chunk(T: int) -> int:
    """Round a lane's chunk length up to a pow2 tier (>= 256): the tier
    decides which symbols each lane owns, so it is part of the format."""
    t = 256
    while t < T:
        t <<= 1
    return t


def _context_counts(syms: np.ndarray, A: int, k: int, T: int) -> np.ndarray:
    """[A^k, A] counts of (context, symbol) over one block's symbol ids,
    lane chunks of T symbols: the context of a symbol is the k before it in
    its chunk, oldest in the highest digit, symbol 0 before the chunk's
    first."""
    at = syms.astype(np.int32)
    for j in range(1, k + 1):
        prev = np.zeros(len(syms), np.int32)
        prev[j:] = syms[:-j]
        for i in range(min(j, T)):
            prev[i::T] = 0          # the chunk's first j symbols
        at += prev * A ** j
    return np.bincount(at, minlength=A ** (k + 1)).reshape(A ** k, A)


def _model(syms: np.ndarray, A: int, k: int) -> Block:
    """One block's order, tier and quantized rows, ready to code."""
    k = _feasible_k(A, k)
    T = _tier_chunk(max(1, -(-len(syms) // LANES)))
    freq = _quantize_rows(_context_counts(syms, A, k, T))
    return Block(len(syms), T, A, A ** k, True, freq.reshape(-1))


def _parse_block(blob: memoryview) -> tuple[Block, np.ndarray, int]:
    """One block header, checked: (block, alphabet, bytes consumed)."""
    if blob[0] != _VERSION or (1 << blob[1]) != LANES:
        raise ValueError("ctx-trans stream: bad block header")
    k = blob[2]
    off = 4
    m, A = np.frombuffer(blob, "<u2", 2, off)
    off += 4
    if m != M:
        raise ValueError(f"ctx-trans stream: table size {m} != {M}")
    A = int(A)
    if not 1 <= A <= 256 or _feasible_k(A, k) != k:
        raise ValueError(f"ctx-trans stream: alphabet {A}, order {k}")
    C = A ** k
    n = int(np.frombuffer(blob, "<u8", 1, off)[0]); off += 8
    alphabet = np.frombuffer(blob, np.uint8, A, off).copy(); off += A
    freq = np.frombuffer(blob, "<u2", C * A, off)
    off += 2 * C * A
    rows = freq.reshape(C, A).sum(axis=1, dtype=np.int64)
    if ((rows != 0) & (rows != M)).any():
        raise ValueError("ctx-trans stream: a table row does not sum to M")
    head = np.frombuffer(blob, "<u4", 2 * LANES, off); off += 8 * LANES
    total_words = int(head[LANES:].sum(dtype=np.int64))
    flat = np.frombuffer(blob, "<u2", total_words, off)
    off += 2 * total_words
    T = _tier_chunk(max(1, -(-n // LANES)))
    return Block(n, T, A, C, True, freq, head, flat), alphabet, off


def remap(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(alphabet, symbol ids) of a byte stream: the byte values it uses, in
    order (one pass, no sort; [0] for an empty stream), and each byte's
    index among them."""
    alphabet = np.flatnonzero(np.bincount(buf, minlength=256)).astype(
        np.uint8) if len(buf) else np.zeros(1, np.uint8)
    ids = np.zeros(256, np.uint8)
    ids[alphabet] = np.arange(len(alphabet), dtype=np.uint8)
    return alphabet, ids[buf]


def compress(data: bytes, k: int, device) -> bytes:
    """Byte stream -> framed context-rANS blocks (alphabet = used bytes).
    An empty stream still writes one block."""
    buf = np.frombuffer(data, np.uint8)
    alphabet, syms = remap(buf)
    A = len(alphabet)
    blocks = [_model(syms[i: i + BLOCK], A, k)
              for i in range(0, max(len(syms), 1), BLOCK)]
    parts = [np.array([len(buf)], "<u8").tobytes()]
    for b in encode_blocks(syms, blocks, device):
        parts += [bytes([_VERSION, LANES.bit_length() - 1,
                         _feasible_k(A, k), 0]),
                  np.array([M, A], "<u2").tobytes(),
                  np.array([b.n], "<u8").tobytes(),
                  alphabet.tobytes(),
                  b.freq.astype("<u2").tobytes(),
                  b.head.astype("<u4").tobytes(),
                  b.words.astype("<u2").tobytes()]
    return b"".join(parts)


def decompress(blob: bytes, device) -> bytes:
    """Every block header is parsed and checked before anything is
    launched, so a corrupt header anywhere in the stream raises its
    ValueError with no work done on the device; then one launch decodes the
    stream."""
    n = int(np.frombuffer(blob, "<u8", 1)[0])
    off = 8
    blocks, alphabets = [], []
    got = 0
    mv = memoryview(blob)
    while got < n:
        block, alphabet, used = _parse_block(mv[off:])
        blocks.append(block)
        alphabets.append(alphabet)
        got += block.n
        off += used
    if got != n:
        raise ValueError(
            f"ctx-trans stream: decoded {got} symbols, header says {n}")
    return b"".join(a[s].tobytes() for a, s in zip(
        alphabets, decode_blocks(blocks, device)))


# ---- dzt: dz LZ transform + on-device entropy ------------------------------
#
# The dz matcher (native dnalz.cpp) strips the long forward and reverse-
# complement repeats; both residual streams then go through the context
# rANS: token byte planes with order-1 contexts, literal bases with order-4.
#
# Layout: u8 'Z' u8 version=1 | u64 raw_len | u32 n_tokens | u64 n_lit_bytes
#         u64 clen_tok | tok ctx-rANS blob | lit ctx-rANS blob (rest)

_DZ_HEAD = 30


def compress_dz(data: bytes, device) -> bytes:
    tok, nt, lit_packed = native.dz_encode_parts(data)
    tok_blob = compress(tok, 1, device)
    lit_codes = np.stack([(np.frombuffer(lit_packed, np.uint8)
                           >> (2 * i)) & 3 for i in range(4)],
                         axis=-1).reshape(-1).astype(np.uint8)
    lit_blob = compress(lit_codes.tobytes(), 4, device)
    head = (b"Z\x01" + np.array([len(data)], "<u8").tobytes()
            + np.array([nt], "<u4").tobytes()
            + np.array([len(lit_packed)], "<u8").tobytes()
            + np.array([len(tok_blob)], "<u8").tobytes())
    return head + tok_blob + lit_blob


def decompress_dz(blob: bytes, device) -> bytes:
    """Both residual planes are checked against the header before the
    native decoder reads them (it reads 12 * n_tokens token bytes)."""
    if len(blob) < _DZ_HEAD or blob[:2] != b"Z\x01":
        raise ValueError("dzt stream: bad magic or short header")
    raw_len = int(np.frombuffer(blob, "<u8", 1, 2)[0])
    nt = int(np.frombuffer(blob, "<u4", 1, 10)[0])
    nlit = int(np.frombuffer(blob, "<u8", 1, 14)[0])
    ctok = int(np.frombuffer(blob, "<u8", 1, 22)[0])
    if _DZ_HEAD + ctok > len(blob):
        raise ValueError("dzt stream: token plane past the end")
    tok = decompress(blob[_DZ_HEAD:_DZ_HEAD + ctok], device)
    if len(tok) != 12 * nt:
        raise ValueError(f"dzt stream: {len(tok)} token bytes for {nt} "
                         "tokens")
    lit_codes = np.frombuffer(decompress(blob[_DZ_HEAD + ctok:], device),
                              np.uint8)
    if len(lit_codes) != nlit * 4:
        raise ValueError("dzt stream: literal length mismatch")
    c = lit_codes.reshape(-1, 4).astype(np.uint16)
    lit_packed = (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4)
                  | (c[:, 3] << 6)).astype(np.uint8).tobytes()
    return native.dz_decode_parts(tok, nt, lit_packed, raw_len)
