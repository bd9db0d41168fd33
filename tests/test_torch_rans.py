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
from minicom_tpu_torch.ops.rans import (LANES, M, rans_decode,
                                        rans_decode_blocks, rans_encode)
from tests.test_torch_cuda import random_batch

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
    freq, cum, slot = trans._tables(freq_q)
    js, jw, jc = (np.asarray(x) for x in jrans._encode_program(T)(
        jnp.asarray(grid), jnp.asarray(valid), jnp.asarray(freq),
        jnp.asarray(cum)))
    ts, tw, tc = (x.numpy() for x in rans_encode(
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
    ts, tw, tc = (x.numpy() for x in rans_encode(_t(f_g), _t(c_g),
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
    z = torch.zeros((4, LANES), dtype=torch.uint32)
    v = torch.ones((4, LANES), dtype=torch.bool)
    with pytest.raises(ValueError):           # f not uint32
        rans_encode(z.to(torch.int64), z, v)
    with pytest.raises(ValueError):           # not 128 lanes
        rans_encode(z[:, :64], z[:, :64], v[:, :64])
    st = torch.zeros(LANES, dtype=torch.uint32)
    w = torch.zeros((1, LANES), dtype=torch.uint16)
    fr = torch.zeros(256, dtype=torch.uint32)
    sl = torch.zeros(M, dtype=torch.uint8)
    with pytest.raises(ValueError):           # tables do not fit C * A
        rans_decode(st, w, v, fr, fr, sl, 256, 2)
    with pytest.raises(ValueError):           # no word rows
        rans_decode(st, w[:0], v, fr, fr, sl, 256, 1)


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
