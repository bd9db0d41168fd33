"""The port's on-device entropy codecs (minicom_tpu_torch.ops.rans and
entropy/device_rans.py, device_ctx_rans.py), with the scans in their plain
PyTorch versions on the CPU, against the JAX package: the device programs
output for output, the streams byte for byte, and decode both ways. Every
comparison is exact."""

import collections
import contextlib
import fcntl
import os
import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minicom_tpu import native as jnative
from minicom_tpu.entropy import backend as jbackend
from minicom_tpu.entropy import device_ctx_rans as jctx
from minicom_tpu.entropy import device_rans as jrans
from minicom_tpu_torch.entropy import backend as tbackend
from minicom_tpu_torch.entropy import device_ctx_rans as tctx
from minicom_tpu_torch.entropy import device_rans as trans
from minicom_tpu_torch.ops import cuda, rans
from minicom_tpu_torch.ops.rans import (LANES, M, _encode_plain,
                                        rans_decode, rans_decode_blocks,
                                        rans_encode_blocks)
from tests.test_torch_cuda import random_batch, random_encode_batch

CPU = torch.device("cpu")
_LOCK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "minicom_tpu_torch", "_build", "jax_native.lock")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native library, loaded. Its loader builds into a
    shared temporary name without a lock, so a test worker can lose a
    concurrent build and keep a failed load (and the Python fallback, which
    the JAX package would then use) for its whole process. Retry the load
    under a file lock; fail if it stays unavailable."""
    if not jnative.has_native():
        os.makedirs(os.path.dirname(_LOCK), exist_ok=True)
        with open(_LOCK, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            for _ in range(5):
                jnative._lib = None
                if jnative.has_native():
                    break
                time.sleep(1)
    assert jnative.has_native(), "minicom_tpu's native library did not load"


def _payload(name, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "uniform": bytes(rng.integers(0, 256, 50_000, dtype=np.uint8)),
        "skewed": bytes(rng.choice([0, 0, 0, 0, 1, 2, 65],
                                   40_000).astype(np.uint8)),
        "const": b"\x00" * 30_000,          # f == M: zero-bit symbols
        "text": (b"0\n" * 5000 + b"17G44\n" * 700),
        "empty": b"",
        "tiny": b"Q",
        # 250 used bytes: trans2's dense table cannot fit, k drops to 1
        "wide": bytes(rng.integers(0, 250, 30_000, dtype=np.uint8)),
        # order-1 structure over 16 symbols: next = prev +- 1
        "markov": ((rng.integers(-1, 2, 40_000).cumsum() % 16) + 48
                   ).astype(np.uint8).tobytes(),
    }[name]


def _packed_dna(seed=0):
    """Repeat-heavy 2-bit-packed DNA (forward and reverse-complement
    copies), the shape of the consensus stream."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, 60_000, dtype=np.uint8)
    full = np.concatenate([seq, (3 - seq)[::-1], seq[5000:20000],
                           rng.integers(0, 4, 20_000, dtype=np.uint8)])
    packed = np.zeros((len(full) + 3) // 4, np.uint8)
    for i in range(4):
        part = full[i::4]
        packed[: len(part)] |= part << (2 * i)
    return packed.tobytes()


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


# ------------------------------------------------------------ program level

@pytest.mark.parametrize("payload", ["uniform", "skewed", "const", "text",
                                     "tiny"])
def test_order0_programs_match_jax(payload):
    """One order-0 block exactly as device_rans._encode_block lays it out:
    the port's encode / decode scans == _encode_program / _decode_program."""
    syms = np.frombuffer(_payload(payload), np.uint8)
    n = len(syms)
    T = jrans._tier(max(1, -(-n // LANES)))
    grid = np.concatenate([syms, np.zeros(T * LANES - n, np.uint8)]
                          ).reshape(T, LANES)
    valid = (np.arange(T * LANES) < n).reshape(T, LANES)
    freq_q = jrans.quantize_freqs(np.bincount(syms, minlength=256))
    freq, cum, slot = jrans._tables(freq_q)
    js, jw, jc = (np.asarray(x) for x in jrans._encode_program(T)(
        jnp.asarray(grid), jnp.asarray(valid), jnp.asarray(freq),
        jnp.asarray(cum)))
    ts, tw, tc = (x.numpy() for x in _encode_plain(
        _t(freq[grid]), _t(cum[grid]), _t(valid)))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tc, jc)
    W = jrans._wtier(max(1, int(jc.max())))
    words = np.zeros((W, LANES), np.uint16)
    words[:min(W, T)] = jw[:W]
    want = np.asarray(jrans._decode_program(T)(
        jnp.asarray(js), jnp.asarray(words), jnp.asarray(valid),
        jnp.asarray(freq), jnp.asarray(cum), jnp.asarray(slot)))
    got = rans_decode(_t(js), _t(words), _t(valid), _t(freq), _t(cum),
                      _t(slot), 256, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert bytes(got.reshape(-1)[:n]) == bytes(syms)


@pytest.mark.parametrize("k,A", [(1, 16), (2, 16), (4, 4), (2, 1)])
def test_context_programs_match_jax(k, A):
    """One context block exactly as device_ctx_rans._encode_block lays it
    out: the port's scans == _encode_program(T) / _decode_program(T, k, A),
    pad slots included."""
    rng = np.random.default_rng(k * 100 + A)
    n = 50_000
    syms = ((rng.integers(-1, 2, n).cumsum() % A)).astype(np.uint8)
    T = jctx._tier_chunk(-(-n // LANES))
    grid = np.concatenate([syms, np.zeros(T * LANES - n, np.uint8)]
                          ).reshape(LANES, T).T.astype(np.int32)
    ctx = jctx._ctx_grid(grid, k, A)
    valid = np.ascontiguousarray(
        np.arange(T * LANES).reshape(LANES, T).T < n)
    C = A ** k
    flat = ctx.astype(np.int64) * A + grid
    freq = jctx._quantize_rows(np.bincount(
        flat.reshape(-1)[valid.reshape(-1)], minlength=C * A).reshape(C, A))
    cum = np.zeros((C, A), np.int64)
    cum[:, 1:] = np.cumsum(freq[:, :-1], axis=1)
    f_g = freq.reshape(-1)[flat].astype(np.uint32)
    c_g = cum.reshape(-1)[flat].astype(np.uint32)
    js, jw, jc = (np.asarray(x) for x in jctx._encode_program(T)(
        jnp.asarray(f_g), jnp.asarray(c_g), jnp.asarray(valid)))
    ts, tw, tc = (x.numpy() for x in _encode_plain(_t(f_g), _t(c_g),
                                                   _t(valid)))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tc, jc)
    W = jrans._wtier(max(1, int(jc.max())))
    words = np.zeros((W, LANES), np.uint16)
    words[:min(W, T)] = jw[:W]
    slot = np.zeros((C, M), np.uint8)
    for c in np.flatnonzero(freq.sum(axis=1) > 0):
        slot[c] = np.repeat(np.arange(A, dtype=np.uint8),
                            freq[c].astype(np.int64))
    args = (words, valid, freq.reshape(-1).astype(np.uint32),
            cum.reshape(-1).astype(np.uint32), slot.reshape(-1))
    want = np.asarray(jctx._decode_program(T, k, A)(
        jnp.asarray(js), *(jnp.asarray(a) for a in args)))
    got = rans_decode(_t(js), *(_t(a) for a in args), A, C).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.T.reshape(-1)[:n], syms)


def _np_tables(fq):
    """[C, A] quantized rows -> (freq, cum, slot_sym) as the JAX package's
    host code builds them: np.repeat per used row, zeros for unused rows."""
    C, A = fq.shape
    cum = np.zeros((C, A), np.int64)
    cum[:, 1:] = np.cumsum(fq[:, :-1], axis=1)
    slot = np.zeros((C, M), np.uint8)
    for c in np.flatnonzero(fq.sum(axis=1) > 0):
        slot[c] = np.repeat(np.arange(A, dtype=np.uint8), fq[c])
    return (fq.reshape(-1).astype(np.uint32), cum.reshape(-1).astype(
        np.uint32), slot.reshape(-1))


@pytest.mark.parametrize("k,A", [(0, 256), (1, 16), (2, 16), (4, 4),
                                 (1, 200)])
def test_plain_decode_blocks_match_jax_programs(k, A):
    """A batch of three blocks of different tiers through the plain
    ``rans_decode_blocks`` == the JAX ``_decode_program`` of each block on
    the word matrix, mask and tables the JAX host code would hand it, every
    slot. Order 0 (k = 0: strided lanes, device_rans) and the context coder
    (chunked lanes, device_ctx_rans); rows with zero-frequency symbols, an
    unused row, a one-symbol row; random states and words."""
    C, chunked = A ** k, k > 0
    specs = [(A, C, 512, chunked, 60_000), (A, C, 256, chunked, 1_000),
             (A, C, 256, chunked, 32_768)]
    head, words, freq, desc, size = random_batch(
        np.random.default_rng(10 * k + A), specs)
    out = rans_decode_blocks(head, words, freq, desc, size).numpy()
    for b, (d, (_, _, T, _, n)) in enumerate(zip(desc.numpy(), specs)):
        counts = head[b, LANES:].numpy().astype(np.int64)
        starts = d[rans.D_WORDS] + np.concatenate([[0], np.cumsum(counts)])
        wm = np.zeros((d[rans.D_W], LANES), np.uint16)
        for l in range(LANES):
            wm[: counts[l], l] = words.numpy()[starts[l]: starts[l + 1]]
        idx = np.arange(T * LANES)
        valid = (idx.reshape(LANES, T).T if chunked
                 else idx.reshape(T, LANES)) < n
        fq = freq.numpy()[d[rans.D_FREQ]: d[rans.D_FREQ] + C * A]
        prog = jctx._decode_program(T, k, A) if chunked \
            else jrans._decode_program(T)
        want = np.asarray(prog(
            jnp.asarray(head[b, :LANES].numpy()), jnp.asarray(wm),
            jnp.asarray(np.ascontiguousarray(valid)),
            *(jnp.asarray(t) for t in _np_tables(
                fq.reshape(C, A).astype(np.int64)))))
        got = out[d[rans.D_OUT]: d[rans.D_OUT] + T * LANES].reshape(T, LANES)
        np.testing.assert_array_equal(got, want, err_msg=f"block {b}")


@pytest.mark.parametrize("rows", [
    [[5, 0, 4091, 0]],                       # zero-frequency symbols
    [[0, 0, 0, 0], [1, 1, 1, 4093]],         # an unused row
    [[0, 4096, 0], [4096, 0, 0], [0, 0, 4096]],   # one symbol, f = M
    [[4096]], [[0]],                         # A = 1, used and unused
    [[0, 0, 1, 0, 4094, 0, 1, 0]],
])
def test_plain_symbol_search_equals_slot_table(rows):
    """The tables the kernel derives from the frequency rows (a search in
    the cumulative row: the count of cum[j] <= slot) == the slot -> symbol
    lookup, frequencies and cumulative frequencies of the host tables."""
    fq = np.array(rows, np.int64)
    C, A = fq.shape
    got = rans._tables_plain(_t(fq.reshape(-1).astype(np.uint16)), A, C)
    for g, w in zip(got, _np_tables(fq)):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_decode_blocks_checks_its_inputs():
    head, words, freq, desc, size = random_batch(
        np.random.default_rng(0), [(4, 4, 256, True, 1000)])
    for col, value in ((rans.D_A, 0), (rans.D_A, 257), (rans.D_C, 1 << 15),
                       (rans.D_T, 0), (rans.D_W, 0), (rans.D_N, 256 * 128 + 1),
                       (rans.D_NWORDS, len(words) + 1), (rans.D_FREQ, 1),
                       (rans.D_OUT, 1)):
        bad = desc.clone()
        bad[0, col] = value
        with pytest.raises(ValueError):
            rans_decode_blocks(head, words, freq, bad, size)
    with pytest.raises(ValueError, match="sums"):   # a row off M
        rans_decode_blocks(head, words, _t(freq.numpy() + 1), desc, size)
    with pytest.raises(ValueError):                 # head of another batch
        rans_decode_blocks(head[:0], words, freq, desc, size)
    with pytest.raises(ValueError, match="lane layout"):   # holes in the
        holes = torch.ones((4, LANES), dtype=torch.bool)   # mask
        holes[1, 5] = False
        fr = torch.zeros(256, dtype=torch.uint32)
        fr[7] = M
        rans_decode(torch.zeros(LANES, dtype=torch.uint32),
                    torch.zeros((1, LANES), dtype=torch.uint16), holes, fr,
                    torch.zeros(256, dtype=torch.uint32),
                    torch.full((M,), 7, dtype=torch.uint8), 256, 1)
    assert rans_decode_blocks(head[:0], words, freq, desc[:0], 0).shape == (0,)


def test_scan_wrappers_check_their_inputs():
    v = torch.ones((4, LANES), dtype=torch.bool)
    sy = torch.zeros(512, dtype=torch.uint8)
    fq = torch.full((256,), 16, dtype=torch.uint16)
    d = torch.tensor([[0, 0, 0, 512, 4, 256, 1, 0]])
    rans_encode_blocks(sy, fq, d)
    with pytest.raises(ValueError):           # symbols not uint8
        rans_encode_blocks(sy.to(torch.int64), fq, d)
    with pytest.raises(ValueError):           # a descriptor of other width
        rans_encode_blocks(sy, fq, d[:, :7])
    st = torch.zeros(LANES, dtype=torch.uint32)
    w = torch.zeros((1, LANES), dtype=torch.uint16)
    fr = torch.zeros(256, dtype=torch.uint32)
    sl = torch.zeros(M, dtype=torch.uint8)
    with pytest.raises(ValueError):           # tables do not fit C * A
        rans_decode(st, w, v, fr, fr, sl, 256, 2)
    with pytest.raises(ValueError):           # no word rows
        rans_decode(st, w[:0], v, fr, fr, sl, 256, 1)


# ------------------------------------------------------------- encode batch

def _lane_words(words, head, d):
    """A block's lane streams from ``rans_encode_blocks``' output, as a
    list of 128 arrays."""
    counts = head[LANES:].astype(np.int64)
    ends = d[rans.E_WORDS] + np.cumsum(counts)
    return [words[e - c: e] for c, e in zip(counts, ends)]


@pytest.mark.parametrize("k,A", [(0, 256), (1, 16), (2, 16), (4, 4),
                                 (1, 200), (2, 1)])
def test_plain_encode_blocks_match_jax_programs(k, A):
    """A batch of five blocks through the plain ``rans_encode_blocks`` ==
    the JAX ``_encode_program`` of each block on the grids the JAX host
    code would hand it: states, counts, every lane's words. Order 0 (k = 0:
    strided lanes, device_rans) and the context coder (chunked lanes,
    device_ctx_rans); a block of another tier, n = 0, n = 1, n one short of
    a tier, a one-symbol block."""
    rng = np.random.default_rng(10 * k + A)
    C, chunked = A ** k, k > 0
    parts, blocks = [], []
    for T, n, one in ((512, 60_000, False), (256, 0, False), (256, 1, False),
                      (256, 256 * LANES - 1, False), (256, 30_000, True)):
        sy = (np.full(n, A - 1) if one
              else rng.integers(-1, 2, n).cumsum() % A).astype(np.uint8)
        parts.append(sy)
        blocks.append(tctx._model(sy, A, k) if chunked else trans._model(sy))
        assert (blocks[-1].T, blocks[-1].C) == (T, C)
    syms, freq, desc = trans.pack_symbols(np.concatenate(parts), blocks, CPU)
    head, words = (x.numpy() for x in rans_encode_blocks(syms, freq, desc))
    for b, (blk, sy) in enumerate(zip(blocks, parts)):
        T, n = blk.T, blk.n
        pad = np.concatenate([sy, np.zeros(T * LANES - n, np.uint8)])
        idx = np.arange(T * LANES)
        if chunked:
            grid = pad.reshape(LANES, T).T.astype(np.int32)
            valid = np.ascontiguousarray(idx.reshape(LANES, T).T < n)
            fq = blk.freq.reshape(C, A)
            cum = np.zeros((C, A), np.int64)
            cum[:, 1:] = np.cumsum(fq[:, :-1], axis=1)
            at = jctx._ctx_grid(grid, k, A).astype(np.int64) * A + grid
            want = jctx._encode_program(T)(
                jnp.asarray(fq.reshape(-1)[at].astype(np.uint32)),
                jnp.asarray(cum.reshape(-1)[at].astype(np.uint32)),
                jnp.asarray(valid))
        else:
            fr, cum, _ = jrans._tables(blk.freq)
            want = jrans._encode_program(T)(
                jnp.asarray(pad.reshape(T, LANES)),
                jnp.asarray(idx.reshape(T, LANES) < n), jnp.asarray(fr),
                jnp.asarray(cum))
        js, jw, jc = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(head[b, :LANES], js, f"block {b}")
        np.testing.assert_array_equal(head[b, LANES:], jc, f"block {b}")
        for l, got in enumerate(_lane_words(words, head[b], desc[b].numpy())):
            np.testing.assert_array_equal(got, jw[: jc[l], l],
                                          f"block {b} lane {l}")


@pytest.mark.parametrize("k,A,chunked,T,n", [
    (0, 256, False, 256, 30_000), (0, 256, False, 256, 100),
    (1, 16, True, 256, 32_768), (2, 16, True, 512, 40_000),
    (4, 4, True, 256, 777), (3, 16, True, 256, 20_000), (2, 1, True, 256, 9),
    (4, 4, True, 3, 300)])
def test_plain_slot_gathers_equal_host_grids(k, A, chunked, T, n):
    """What the plain encode finds per slot with torch ops (context,
    frequency, cumulative frequency, validity) == the numpy grids of the
    JAX package's host code (``_ctx_grid`` and the ``freq[flat]`` /
    ``cum[flat]`` gathers), on rows with zero-frequency symbols and an
    unused context."""
    syms, freq, desc = random_encode_batch(
        np.random.default_rng(n), [(A, k, T, chunked, n, "markov")])
    C = A ** k
    f, c, valid = (x.numpy() for x in rans._slots_plain(
        syms, freq, n, T, A, C, k, chunked))
    pad = np.concatenate([syms.numpy(), np.zeros(T * LANES - n, np.uint8)])
    idx = np.arange(T * LANES)
    if chunked:
        grid = pad.reshape(LANES, T).T.astype(np.int32)
        want_valid = idx.reshape(LANES, T).T < n
    else:
        grid = pad.reshape(T, LANES).astype(np.int32)
        want_valid = idx.reshape(T, LANES) < n
    fq = freq.numpy().reshape(C, A).astype(np.int64)
    cum = np.zeros((C, A), np.int64)
    cum[:, 1:] = np.cumsum(fq[:, :-1], axis=1)
    at = jctx._ctx_grid(grid, k, A).astype(np.int64) * A + grid
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(f, fq.reshape(-1)[at])
    np.testing.assert_array_equal(c, cum.reshape(-1)[at])


@pytest.mark.parametrize("k,A,n", [(1, 16, 40_000), (2, 16, 32_768),
                                   (4, 4, 5), (2, 200, 1000), (2, 1, 300),
                                   (1, 7, 0)])
def test_context_counts_equal_grid_counts(k, A, n):
    """The (context, symbol) counts taken on the stream as it lies ==
    those of the JAX package's [T, 128] grids."""
    rng = np.random.default_rng(n + k)
    syms = rng.integers(0, A, n).astype(np.uint8)
    k = tctx._feasible_k(A, k)
    T = tctx._tier_chunk(max(1, -(-n // LANES)))
    grid = np.concatenate([syms, np.zeros(T * LANES - n, np.uint8)]
                          ).reshape(LANES, T).T.astype(np.int32)
    valid = np.arange(T * LANES).reshape(LANES, T).T < n
    at = jctx._ctx_grid(grid, k, A).astype(np.int64) * A + grid
    want = np.bincount(at[valid], minlength=A ** (k + 1)).reshape(A ** k, A)
    np.testing.assert_array_equal(tctx._context_counts(syms, A, k, T), want)


def _div_by_recip(xr, m):
    """csrc/rans.cu's ``code_slot``: xr // f from m = floor((2^64 - 1) / f)
    as the high half of xr * (m + 1), two 32 x 32 -> 64 bit multiply-adds.
    Python integers, or numpy uint64 (whose products wrap as the kernel's
    would)."""
    p0 = xr * (m & 0xFFFFFFFF) + xr
    p1 = xr * (m >> 32) + (p0 >> 32)
    return p1 >> 32


@pytest.mark.parametrize("lo", [1, 1025, 2049, 3073])
def test_division_by_reciprocal_is_exact(lo):
    """The encode kernel's quotient == xr // f for every f in 1..4096 and
    xr below f * 2^20 (and up to 2^32): the edges in Python integers, where
    a sum that passed 2^64 would show, and 10^5 random values for each f in
    numpy uint64. Its emit test, one compare against (f << 20) - 1 in
    uint32, == (x >> 20) >= f on the same values."""
    rng = np.random.default_rng(lo)
    for f in range(lo, lo + 1024):
        m = ((1 << 64) - 1) // f
        top = f << 20
        mult = [int(v) * f for v in rng.integers(0, 1 << 20, 8)]
        for xr in {0, 1, 1 << 16, top - 1, top - f, top % (1 << 32), *mult,
                   *(v + 1 for v in mult), *(max(v - 1, 0) for v in mult),
                   (1 << 32) - 1}:
            p0 = xr * (m & 0xFFFFFFFF) + xr
            p1 = xr * (m >> 32) + (p0 >> 32)
            assert p0 < 1 << 64 and p1 < 1 << 64
            assert _div_by_recip(xr, m) == xr // f, (xr, f)
            assert (xr > ((f << 20) - 1) % (1 << 32)) == ((xr >> 20) >= f)
        xr = rng.integers(0, top, 100_000, dtype=np.uint64)
        got = _div_by_recip(xr, np.uint64(m))
        np.testing.assert_array_equal(got, xr // np.uint64(f), str(f))


def test_encode_blocks_checks_its_inputs():
    syms, freq, desc = random_encode_batch(
        np.random.default_rng(0), [(4, 2, 256, True, 1000, "rand"),
                                   (256, 0, 256, False, 500, "rand")])
    rans_encode_blocks(syms, freq, desc)
    for row, col, value in (
            (0, rans.E_A, 0), (0, rans.E_A, 257), (0, rans.E_C, 1 << 15),
            (0, rans.E_C, 12),                  # not a power of A
            (0, rans.E_T, 0), (0, rans.E_N, 256 * 128 + 1),
            (0, rans.E_SYMS, -1), (1, rans.E_SYMS, 1001),   # past the end
            (1, rans.E_FREQ, 65), (0, rans.E_WORDS, 1 << 31),
            (1, rans.E_WORDS, 999),             # onto block 0's words
            (1, rans.E_CHUNKED, 1), (0, rans.E_CHUNKED, 0)):
        bad = desc.clone()
        bad[row, col] = value
        if (row, col) == (1, rans.E_CHUNKED):   # order 0, chunked: allowed
            rans_encode_blocks(syms, freq, bad)
            continue
        with pytest.raises(ValueError):
            rans_encode_blocks(syms, freq, bad)
    five = torch.tensor([[0, 0, 0, 100, 256, 2, 32, 1]])   # k = 5
    with pytest.raises(ValueError, match="k <= 4"):
        rans_encode_blocks(torch.zeros(100, dtype=torch.uint8),
                           torch.zeros(64, dtype=torch.uint16), five)
    with pytest.raises(ValueError, match="outside its alphabet"):
        rans_encode_blocks(syms + 4, freq, desc)
    with pytest.raises(ValueError, match="frequency above"):
        rans_encode_blocks(syms, _t(freq.numpy() + 4096), desc)
    with pytest.raises(ValueError, match="devices"):
        rans_encode_blocks(syms, freq.to("meta"), desc)
    with pytest.raises(ValueError, match="on the CPU"):
        rans_encode_blocks(syms, freq, desc.to("meta"))
    head, words = rans_encode_blocks(syms[:0], freq[:0], desc[:0])
    assert head.shape == (0, 2 * LANES) and words.shape == (0,)
    with pytest.raises(ValueError, match="symbols for blocks"):
        trans.encode_blocks(np.zeros(5, np.uint8), [trans._model(
            np.zeros(4, np.uint8))], CPU)


@pytest.mark.parametrize("data", [b"", b"\x07" * 50, bytes(range(256)) * 3,
                                  b"17G44\n0\n" * 9])
def test_alphabet_by_bincount_equals_unique(data):
    buf = np.frombuffer(data, np.uint8)
    alphabet, ids = tctx.remap(buf)
    want = np.unique(buf) if len(buf) else np.zeros(1, np.uint8)
    np.testing.assert_array_equal(alphabet, want)
    assert alphabet.dtype == np.uint8 and ids.dtype == np.uint8
    np.testing.assert_array_equal(alphabet[ids], buf)


# ------------------------------------------------------------- stream level

def _both_ways(codec, data):
    jb = jbackend.compress(codec, data)
    tb = tbackend.compress(codec, data, CPU)
    assert tb == jb
    assert tbackend.decompress(codec, jb, len(data), CPU) == data
    assert jbackend.decompress(codec, tb, len(data)) == data
    return tb


@pytest.mark.parametrize("codec", ["trans", "trans1", "trans2"])
@pytest.mark.parametrize("payload", ["uniform", "skewed", "const", "text",
                                     "empty", "tiny"])
def test_stream_identical(codec, payload):
    _both_ways(codec, _payload(payload))


@pytest.mark.parametrize("codec,payload", [
    ("trans2", "wide"), ("trans1", "wide"), ("trans1", "markov"),
    ("trans2", "markov"), ("p2:trans1", "uniform"), ("p2:trans1", "text"),
    ("p4:trans1", "skewed"), ("p2:trans", "skewed")])
def test_stream_identical_more(codec, payload):
    _both_ways(codec, _payload(payload))


def test_wide_alphabet_drops_order():
    blob = _both_ways("trans2", _payload("wide"))
    assert blob[8 + 2] == 1                     # k shipped in the header
    assert tctx._feasible_k(250, 2) == 1


def test_order0_multiblock_identical():
    """More than BLOCK symbols: a full block and a padded tail tier."""
    rng = np.random.default_rng(9)
    data = bytes(rng.choice([3, 7, 7, 7, 9], trans.BLOCK + 12345
                            ).astype(np.uint8))
    _both_ways("trans", data)


@pytest.mark.parametrize("seed", [0, 1])
def test_dzt_identical(seed):
    _both_ways("dzt", _packed_dna(seed))


def test_dzt_tiny_identical():
    _both_ways("dzt", bytes([0b11100100]) * 3)


def test_dzt_short_token_plane_raises_before_native(monkeypatch):
    """A crafted blob whose header promises more tokens than its token
    plane holds is refused before the native decoder would read past the
    plane."""
    data = _packed_dna()
    blob = bytearray(tbackend.compress("dzt", data, CPU))
    nt = int(np.frombuffer(bytes(blob[10:14]), "<u4")[0])
    blob[10:14] = np.array([nt + 1000], "<u4").tobytes()

    def never(*a):
        raise AssertionError("native decoder reached")

    monkeypatch.setattr(tctx.native, "dz_decode_parts", never)
    with pytest.raises(ValueError, match="token"):
        tbackend.decompress("dzt", bytes(blob), len(data), CPU)
    with pytest.raises(ValueError, match="short header"):
        tbackend.decompress("dzt", bytes(blob[:20]), len(data), CPU)


@pytest.mark.parametrize("codec,offset,value", [
    ("trans", 8 + 12, 0xFF),      # order-0 table no longer sums to M
    ("trans1", 8 + 2, 9),         # an order the alphabet cannot have
    ("trans1", 8 + 16 + 16 + 1, 0xFF),  # a context row off M (A = 16)
])
def test_corrupt_block_headers_raise(codec, offset, value):
    data = _payload("markov")
    blob = bytearray(tbackend.compress(codec, data, CPU))
    blob[offset] = value
    with pytest.raises(ValueError):
        tbackend.decompress(codec, bytes(blob), len(data), CPU)


@pytest.fixture
def small_blocks(monkeypatch):
    """BLOCK of both packages' coders shrunk to 2^16 symbols, so a short
    stream has several blocks and the plain scans stay short."""
    for mod in (jrans, jctx, trans, tctx):
        monkeypatch.setattr(mod, "BLOCK", 1 << 16)


@pytest.mark.parametrize("codec", ["trans", "trans1", "trans2"])
def test_multiblock_streams_identical(small_blocks, codec):
    """Two full blocks (T = 512) and a tail of another tier (T = 256): the
    port's stream == the JAX stream, decoded both ways; the port decodes it
    in one ``rans_decode_blocks`` call."""
    data = (_payload("markov") + _payload("text") + _payload("skewed")
            + _payload("markov", 1) + _payload("uniform"))[:150_000]
    calls = []
    real = rans.rans_decode_blocks

    def counted(*a, **kw):
        calls.append(a[3].shape[0])
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rans, "rans_decode_blocks", counted)
        _both_ways(codec, data)
    assert calls == [3]


def test_multiblock_dzt_identical(small_blocks):
    _both_ways("dzt", _packed_dna(2))


_BAD_HEADERS = {   # codec: [(offset in the block, bytes, message)]
    "trans": [(0, b"\x07", "bad block header"), (1, b"\x06", "bad block"),
              (2, b"\x00\x20", "table size"), (12, b"\xff", "sum to M"),
              (4, b"\x00" * 7 + b"\x01", "block of")],
    "trans1": [(0, b"\x07", "bad block header"), (1, b"\x06", "bad block"),
               (4, b"\x00\x20", "table size"), (2, b"\x09", "order 9"),
               (6, b"\x00\x00", "alphabet 0"),
               (16 + 16 + 1, b"\xff", "row does not sum")],
}


@pytest.mark.parametrize("codec,case", [
    (c, i) for c, cases in _BAD_HEADERS.items() for i in range(len(cases))])
def test_corrupt_second_block_header_raises_before_any_decode(
        small_blocks, monkeypatch, codec, case):
    """Every header check of both coders, with the bad header in the second
    block of the stream: its ValueError, and nothing handed to the scan."""
    data = _payload("markov") + _payload("markov", 1)
    blob = bytearray(tbackend.compress(codec, data, CPU))
    parse = trans._parse_block if codec == "trans" else tctx._parse_block
    second = 8 + parse(memoryview(bytes(blob))[8:])[-1]
    off, value, message = _BAD_HEADERS[codec][case]
    blob[second + off: second + off + len(value)] = value

    def never(*a, **kw):
        raise AssertionError("the scan was reached")

    monkeypatch.setattr(rans, "rans_decode_blocks", never)
    with pytest.raises(ValueError, match=message):
        tbackend.decompress(codec, bytes(blob), len(data), CPU)


def test_launch_count_is_thread_safe(monkeypatch):
    """The container launches kernels from a thread pool: concurrent
    launches must not lose counts (a fake library stands in for the
    card)."""
    monkeypatch.setattr(cuda, "lib", lambda: types.SimpleNamespace(
        mtc_fake=lambda *a: 0))
    class Counter(collections.Counter):
        def __getitem__(self, key):    # Python-level: threads can switch
            return super().__getitem__(key)  # between the read and write

    monkeypatch.setattr(cuda, "launches", Counter())
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    t = torch.zeros(1)

    def work():
        for _ in range(10000):
            cuda.launch("mtc_fake", t, 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert cuda.launches["mtc_fake"] == 16 * 10000


def test_device_codecs_need_a_device():
    with pytest.raises(ValueError, match="device"):
        tbackend.compress("trans1", b"abc")
    blob = tbackend.compress("trans", b"abc", CPU)
    with pytest.raises(ValueError, match="device"):
        tbackend.decompress("trans", blob, 3)


def test_cuda_scans_need_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tbackend.compress("trans", b"abc", torch.device("cuda"))
