"""Order-0 interleaved rANS on the device (codec "trans"; also "pK:trans"
through the byte-plane transform of ``entropy/backend.py``). The format is
the JAX package's ``minicom_tpu/entropy/device_rans.py``, byte for byte.

Static-table rANS over uint8 symbols across LANES independent coder states
(lane l owns symbols l, l+LANES, l+2*LANES, ...): 32-bit states, 16-bit
renormalisation, frequencies quantized on the host to M = 2^12 by
deterministic largest-remainder rounding (float64 numpy; the table ships in
the block header, so decode needs no float math). The scans run in
``ops/rans.py``: CUDA kernels on a CUDA ``device``, their plain PyTorch
versions on ``device="cpu"``. Encode counts and quantizes every block of a
stream on the host, then codes all its blocks in one kernel launch (the
symbols and the tables go up in one copy; the states and word counts come
down in one, the lane streams in one more); decode parses every block
header of a stream on the host, then decodes all its blocks in one launch
(one upload, one launch, one download per stream).

Stream layout (little-endian): u64 n_symbols, then per block of at most
BLOCK symbols:
  u8  version (=1)       u8 log2(LANES)       u16 M (=4096)
  u64 n_symbols
  u16 freq[256]          (quantized; absent symbols 0)
  u32 state[LANES]       (encoder final = decoder initial states)
  u32 words_per_lane[LANES]
  u16 lane streams, concatenated in lane order (decode read order)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from minicom_tpu_torch.ops import cuda, rans
from minicom_tpu_torch.ops.rans import LANES, M

_VERSION = 1
# symbols per block; tail blocks round T up to a pow2 tier (the tier fixes
# which slots are padding, so it is part of the format)
BLOCK = 1 << 20


def quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Deterministic largest-remainder quantization of a 256-bin histogram
    to sum exactly M, every present symbol >= 1."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        q = np.zeros(256, np.int64)
        q[0] = M
        return q.astype(np.uint16)
    scaled = counts * M / total
    q = np.floor(scaled).astype(np.int64)
    q[(counts > 0) & (q == 0)] = 1
    diff = M - int(q.sum())
    if diff > 0:
        # hand the deficit to the largest remainders (ties: lower symbol)
        rem = scaled - np.floor(scaled)
        rem[counts == 0] = -1.0
        order = np.lexsort((np.arange(256), -rem))
        q[order[:diff]] += 1
    else:
        # take the surplus from the largest entries that stay >= 1
        for _ in range(-diff):
            cand = np.flatnonzero(q > 1)
            q[cand[np.argmax(q[cand])]] -= 1
    assert q.sum() == M
    return q.astype(np.uint16)


def _tier(T: int) -> int:
    """Round a tail-block step count up to a pow2 tier (>= 256)."""
    full = BLOCK // LANES
    if T >= full:
        return full
    t = 256
    while t < T:
        t <<= 1
    return t


def _wtier(W: int) -> int:
    """Round the per-lane word-matrix height up to a pow2 tier (>= 64).
    Zero rows are safe: decode reads words[min(ptr, W-1)] and the validity
    mask stops every lane at its own word count."""
    t = 64
    while t < W:
        t <<= 1
    return t


@dataclasses.dataclass
class Block:
    """One rANS block, as its header holds it (before it is coded, without
    ``head`` and ``words``)."""
    n: int                 # symbols
    T: int                 # steps per lane
    A: int                 # alphabet size
    C: int                 # contexts
    chunked: bool          # lane l owns symbols [l*T, (l+1)*T), else l::128
    freq: np.ndarray       # u16 [C * A] quantized rows
    head: np.ndarray = None    # u32 [256]: lane states, then words per lane
    words: np.ndarray = None   # u16 lane streams, concatenated in lane order


def _upload(arrays: list[np.ndarray], device) -> list[torch.Tensor]:
    """Host arrays -> 1-d device tensors of their dtypes through one copy
    (a byte buffer with every array on a 16-byte boundary)."""
    offs = np.cumsum([0] + [-(-a.nbytes // 16) * 16 for a in arrays])
    buf = np.zeros(int(offs[-1]), np.uint8)
    for a, o in zip(arrays, offs):
        buf[o: o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    dev = cuda.to_device(buf, device)
    return [dev[o: o + a.nbytes].view(getattr(torch, a.dtype.name))
            for a, o in zip(arrays, offs)]


def _model(syms: np.ndarray) -> Block:
    """One block's tier and quantized table, ready to code."""
    return Block(len(syms), _tier(max(1, -(-len(syms) // LANES))), 256, 1,
                 False, quantize_freqs(np.bincount(syms, minlength=256)))


def pack_symbols(syms: np.ndarray, blocks: list[Block], device):
    """The arguments of ``rans_encode_blocks`` for these blocks, block i
    coding the next ``blocks[i].n`` symbol ids of ``syms`` (uint8): (syms,
    freq) on ``device`` through one copy, and the descriptors."""
    desc = np.zeros((len(blocks), rans.ENC_FIELDS), np.int64)
    s_off = f_off = 0
    for d, b in zip(desc, blocks):
        # a block emits at most one word per symbol: its words lie where
        # its symbols do
        d[:] = (s_off, f_off, s_off, b.n, b.T, b.A, b.C, b.chunked)
        s_off += b.n
        f_off += len(b.freq)
    if s_off != len(syms):
        raise ValueError(f"{len(syms)} symbols for blocks of {s_off}")
    up_syms, up_freq = _upload(
        [syms, np.concatenate([b.freq for b in blocks]).astype(np.uint16)],
        device)
    return up_syms, up_freq, torch.from_numpy(desc)


def unpack_words(blocks: list[Block], desc: torch.Tensor, head: torch.Tensor,
                 words: torch.Tensor) -> list[Block]:
    """``blocks`` with what ``rans_encode_blocks`` gave for them: one
    download of the states and word counts, then one of the lane streams
    (the words each block emitted, not the room it was given)."""
    head = cuda.to_host(head).numpy()
    totals = head[:, LANES:].sum(axis=1, dtype=np.int64)
    words = words.view(torch.int16)      # torch.cat takes no uint16
    flat = cuda.to_host(torch.cat([words[o: o + t] for o, t in zip(
        desc[:, rans.E_WORDS].tolist(), totals)])).numpy().view(np.uint16)
    ends = np.cumsum(totals)
    return [dataclasses.replace(b, head=head[i], words=flat[e - t: e])
            for i, (b, t, e) in enumerate(zip(blocks, totals, ends))]


def encode_blocks(syms: np.ndarray, blocks: list[Block], device
                  ) -> list[Block]:
    """``blocks`` coded, in stream order: one upload, one
    ``rans_encode_blocks`` call, two downloads."""
    if not blocks:
        return []
    up_syms, up_freq, desc = pack_symbols(syms, blocks, device)
    return unpack_words(blocks, desc, *rans.rans_encode_blocks(
        up_syms, up_freq, desc))


def pack_blocks(blocks: list[Block], device):
    """The arguments of ``rans_decode_blocks`` for these blocks: (head,
    words, freq) on ``device`` through one copy, the descriptors, the output
    size."""
    desc = np.zeros((len(blocks), rans.DESC_FIELDS), np.int64)
    w_off = f_off = o_off = 0
    for d, b in zip(desc, blocks):
        d[:] = (w_off, len(b.words), f_off, o_off, b.n, b.T,
                _wtier(max(1, int(b.head[LANES:].max()))), b.A, b.C,
                b.chunked)
        w_off += len(b.words)
        f_off += len(b.freq)
        o_off += b.T * LANES
    head, words, freq = _upload(
        [np.concatenate([b.head for b in blocks]).astype(np.uint32),
         np.concatenate([b.words for b in blocks]).astype(np.uint16),
         np.concatenate([b.freq for b in blocks]).astype(np.uint16)], device)
    return (head.view(len(blocks), 2 * LANES), words, freq,
            torch.from_numpy(desc), o_off)


def unpack_symbols(blocks: list[Block], out: np.ndarray) -> list[np.ndarray]:
    """Each block's n symbols in stream order from the decoded grids:
    chunked lanes own columns of the stream, strided lanes rows."""
    syms, off = [], 0
    for b in blocks:
        grid = out[off: off + b.T * LANES].reshape(b.T, LANES)
        syms.append((grid.T if b.chunked else grid).reshape(-1)[: b.n])
        off += b.T * LANES
    return syms


def decode_blocks(blocks: list[Block], device) -> list[np.ndarray]:
    """The symbols of each block, in stream order: one upload, one
    ``rans_decode_blocks`` call, one download."""
    if not blocks:
        return []
    out = rans.rans_decode_blocks(*pack_blocks(blocks, device))
    return unpack_symbols(blocks, cuda.to_host(out).numpy())


def _parse_block(blob) -> tuple[Block, int]:
    """One block header, checked: (block, bytes consumed)."""
    blob = memoryview(blob)
    if blob[0] != _VERSION or (1 << blob[1]) != LANES:
        raise ValueError("trans stream: bad block header "
                         f"(version {blob[0]}, lanes 2^{blob[1]})")
    off = 2
    m = int(np.frombuffer(blob, "<u2", 1, off)[0]); off += 2
    if m != M:
        raise ValueError(f"trans stream: table size {m} != {M}")
    n = int(np.frombuffer(blob, "<u8", 1, off)[0]); off += 8
    freq_q = np.frombuffer(blob, "<u2", 256, off); off += 512
    if int(freq_q.sum(dtype=np.int64)) != M:
        raise ValueError("trans stream: frequency table does not sum to M")
    head = np.frombuffer(blob, "<u4", 2 * LANES, off); off += 8 * LANES
    total_words = int(head[LANES:].sum(dtype=np.int64))
    flat = np.frombuffer(blob, "<u2", total_words, off)
    off += 2 * total_words
    T = _tier(max(1, -(-n // LANES)))
    if n > T * LANES:
        raise ValueError(f"trans stream: block of {n} symbols")
    return Block(n, T, 256, 1, False, freq_q, head, flat), off


def compress(data: bytes, device) -> bytes:
    """Codec entry: uint8 stream -> framed rANS blocks, each over at most
    BLOCK symbols with its own table; one launch codes them all."""
    syms = np.frombuffer(data, np.uint8)
    blocks = [_model(syms[i: i + BLOCK]) for i in range(0, len(syms), BLOCK)]
    parts = [np.array([len(syms)], "<u8").tobytes()]
    for b in encode_blocks(syms, blocks, device):
        parts += [bytes([_VERSION, LANES.bit_length() - 1]),
                  np.array([M], "<u2").tobytes(),
                  np.array([b.n], "<u8").tobytes(),
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
    blocks = []
    got = 0
    while got < n:
        block, used = _parse_block(memoryview(blob)[off:])
        blocks.append(block)
        got += block.n
        off += used
    if got != n:
        raise ValueError(
            f"trans stream: decoded {got} symbols, header says {n}")
    return b"".join(s.tobytes() for s in decode_blocks(blocks, device))
