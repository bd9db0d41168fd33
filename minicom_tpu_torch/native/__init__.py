"""Host C++ of the pipeline: the seven sources beside this file (the
format-critical diff grammar, range coders and dz matcher, the FASTQ parser,
the realign probe, the merge probe and scorer, and the host twins of the
sketch and vote kernels), compiled at first use, never at import, into
``minicom_tpu_torch/_build/`` and bound with ctypes.

The sources began as byte-for-byte copies of ``minicom_tpu/native/*.cpp`` at
commit 15e3f81a1affa071cf677edbe96a18b657d467f7. This package owns them from
then on: a change here leaves the JAX package alone, and
``tests/test_torch_native.py`` holds every entry point to the JAX package's
on the same inputs.

``build_shared`` is also the builder of the CUDA kernels (``ops/cuda.py``):
the output name carries a hash of the sources and the command, so a changed
source is rebuilt, and the build runs under an exclusive ``flock`` into a
per-process temporary name, so concurrent test workers never race.

The library is required: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_SRC_DIR)
_BUILD_DIR = os.path.join(_PKG, "_build")
_SRCS = [os.path.join(_SRC_DIR, f) for f in (
    "diffcodec.cpp", "rangecoder.cpp", "realign.cpp", "fastq.cpp",
    "consensus.cpp", "sketch.cpp", "dnalz.cpp")]


def build_shared(stem: str, srcs: list[str], cmd_for,
                 suffix: str = ".so") -> str:
    """Build ``srcs`` into ``_build/<stem>-<hash><suffix>`` unless it exists;
    ``cmd_for(out_path)`` gives the compiler command. Returns the path."""
    h = hashlib.sha1(" ".join(cmd_for("")).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}{suffix}")
    if os.path.exists(so):
        return so
    with open(os.path.join(_BUILD_DIR, f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            r = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"building {stem} failed:\n{r.stderr}")
            os.replace(tmp, so)
    return so


_P, _I64, _I32, _INT, _U32 = (ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_int32, ctypes.c_int, ctypes.c_uint32)
# name: (restype, argtypes)
_SIGS = {
    "diff_encode": (_I64, [_P, _P, _I64, _I64, _INT, _P]),
    "diff_decode": (_I64, [_P, _I64, _P, _I64, _I64, _P]),
    "diff_encode_lengths": (None, [_P, _P, _I64, _I64, _INT, _P]),
    "diff_encode_win": (_I64, [_P, _P, _P, _P, _I64, _I64, _INT, _P]),
    "diff_decode_win_strided": (_I64, [_P, _I64, _P, _P, _P, _I64, _I64, _P,
                                       _I64]),
    "decode_cluster_meta": (_I64, [_P, _I64, _P, _P, _I64, _P, _I64, _I64,
                                   _U32, _P, _P]),
    "dz_encode": (_I64, [_P, _I64, _P, _I64]),
    "dz_decode": (_I64, [_P, _I64, _P, _I64]),
    "dz_encode_parts": (_I64, [_P, _I64, _P, _I64, _P, _I64, _P, _P]),
    "dz_decode_parts": (_I64, [_P, _I64, _P, _I64, _P, _I64]),
    "rc_encode_blocked": (_I64, [_INT, _P, _I64, _I64, _P, _I64]),
    "rc_decode_blocked": (_I64, [_INT, _P, _I64, _P, _I64]),
    "realign_probe": (_I64, [_P, _P, _I64, _P, _I64, _I64, _P, _I32, _I32,
                             _I32, _I32, _I32, _P, _P, _P, _P, _P, _I64]),
    "fastq_scan": (_I64, [_P, _I64, _P, _P]),
    "fastq_extract": (_I64, [_P, _I64, _I64, _I64, _P]),
    "set_num_threads": (None, [_INT]),
    "score_overlaps": (None, [_P, _P, _P, _P, _P, _I64, _I32, _P]),
    "sketch_windowed_host": (None, [_P, _P, _P, _I64, _I32, _P, _P, _I32, _P,
                                    _P, _P]),
    "sketch_reads_host": (None, [_P, _I64, _P, _I64, _I32, _P, _P, _P, _P]),
    "popcounts_at": (None, [_P, _I64, _P, _I64, _P, _P]),
    "probe_index_pairs": (_I64, [_P, _P, _P, _P, _I64, _P, _P, _P, _P, _I64,
                                 _I32, _P, _P, _P, _P, _I64]),
    "consensus_host": (None, [_P, _I64, _I64, _P, _P, _I64, _P, _P, _I64, _I64,
                              _INT, _P, _P]),
}

_lib = None


def _load():
    global _lib
    if _lib is None:
        so = build_shared("_native", _SRCS, lambda out: [
            "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
            *_SRCS, "-o", out])
        lib = ctypes.CDLL(so)
        for name, (res, args) in _SIGS.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
    return _lib


def _as_c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def diff_encode(ref_rows: np.ndarray, read_rows: np.ndarray, rule: int) -> bytes:
    """ref/read: [M, L] uint8 ASCII -> '\n'-separated diff lines (bytes)."""
    M, L = read_rows.shape
    if M == 0:
        return b""
    ref_rows, read_rows = _as_c(ref_rows), _as_c(read_rows)
    out = np.empty(M * (L + 12), dtype=np.uint8)
    n = _load().diff_encode(ref_rows.ctypes.data, read_rows.ctypes.data,
                            M, L, rule, out.ctypes.data)
    return out[:n].tobytes()


def diff_decode(text: bytes, ref_rows: np.ndarray, n_rows: int) -> np.ndarray:
    """'\n'-separated diff lines + [M, L] uint8 ASCII refs -> read rows."""
    M, L = ref_rows.shape
    if M != n_rows:
        raise ValueError(f"diff_decode: {M} reference rows for {n_rows} reads")
    if M == 0:
        return np.zeros((0, L), np.uint8)
    ref_rows = _as_c(ref_rows)
    buf = np.frombuffer(text, dtype=np.uint8)
    out = np.empty((M, L), dtype=np.uint8)
    r = _load().diff_decode(buf.ctypes.data, len(buf), ref_rows.ctypes.data,
                            M, L, out.ctypes.data)
    if r != M:
        raise ValueError(f"diff_decode failed at row {-r - 1}")
    return out


def diff_encode_lengths(ref_rows: np.ndarray, read_rows: np.ndarray,
                        rule: int) -> np.ndarray:
    """Per-row encoded length (without the newline)."""
    M, L = read_rows.shape
    if M == 0:
        return np.zeros(0, np.int32)
    ref_rows, read_rows = _as_c(ref_rows), _as_c(read_rows)
    out = np.empty(M, dtype=np.int32)
    _load().diff_encode_lengths(ref_rows.ctypes.data, read_rows.ctypes.data,
                                M, L, rule, out.ctypes.data)
    return out


def diff_encode_win(ref_codes: np.ndarray, win_base: np.ndarray,
                    read_codes: np.ndarray, dirs, rule: int) -> bytes:
    """Windowed diff encode on base codes: row r's ref window starts at
    ref_codes[win_base[r]]; read row r is reverse-complemented when
    dirs[r] == 1."""
    M, L = read_codes.shape
    if M == 0:
        return b""
    ref_codes = _as_c(ref_codes)
    read_codes = _as_c(read_codes)
    win_base = np.ascontiguousarray(win_base, np.int64)
    dirs = np.ascontiguousarray(dirs, np.int8)
    out = np.empty(M * (L + 12), dtype=np.uint8)
    n = _load().diff_encode_win(ref_codes.ctypes.data, win_base.ctypes.data,
                                read_codes.ctypes.data, dirs.ctypes.data, M, L,
                                rule, out.ctypes.data)
    return out[:n].tobytes()


def diff_decode_win(text: bytes, ref_codes: np.ndarray, win_base: np.ndarray,
                    dirs: np.ndarray, n_rows: int, L: int,
                    out: np.ndarray) -> np.ndarray:
    """Windowed diff decode into ``out``, an [n_rows, L] uint8 view whose
    rows are contiguous (it may be the [:, :L] slice of an [n, L+1]
    lines matrix): ASCII read rows, reverse-complemented where dirs == 1."""
    if n_rows == 0:
        return out
    if not (out.shape == (n_rows, L) and out.dtype == np.uint8
            and out.strides[1] == 1 and out.strides[0] >= L):
        raise ValueError("diff_decode_win: bad output view")
    ref_codes = _as_c(ref_codes)
    win_base = np.ascontiguousarray(win_base, np.int64)
    dirs = np.ascontiguousarray(dirs, np.int8)
    buf = np.frombuffer(text, dtype=np.uint8)
    r = _load().diff_decode_win_strided(
        buf.ctypes.data, len(buf), ref_codes.ctypes.data,
        win_base.ctypes.data, dirs.ctypes.data, n_rows, L,
        out.ctypes.data, out.strides[0])
    if r != n_rows:
        raise ValueError(f"diff_decode_win failed at row {-r - 1}")
    return out


def decode_cluster_meta(cnt: np.ndarray, d16: np.ndarray, dx: np.ndarray,
                        dirbits: np.ndarray, M: int, L: int, esc: int):
    """Cluster streams -> (win_base int64[M], dirs int8[M], ref_total bases)
    in one native pass."""
    cnt = np.ascontiguousarray(cnt, np.uint32)
    d16 = np.ascontiguousarray(d16, np.uint16)
    dx = np.ascontiguousarray(dx, np.uint32)
    dirbits = np.ascontiguousarray(dirbits, np.uint8)
    if len(d16) < M or 8 * len(dirbits) < M:
        raise ValueError("corrupt cluster metadata streams")
    win_base = np.empty(M, np.int64)
    dirs = np.empty(M, np.int8)
    total = _load().decode_cluster_meta(
        cnt.ctypes.data, len(cnt), d16.ctypes.data, dx.ctypes.data, len(dx),
        dirbits.ctypes.data, M, L, esc, win_base.ctypes.data,
        dirs.ctypes.data)
    if total < 0:
        raise ValueError("corrupt cluster metadata streams")
    return win_base, dirs, int(total)


# family ids and independent-block sizes (bytes of raw stream) of the
# blocked range coder (rangecoder.cpp); fixed, so archives never depend on
# the thread count
_RC_FAMILY = {"o1rc": 0, "o2rc": 1, "dnarc": 2}
_RC_BLOCK = {"o1rc": 8 << 20, "o2rc": 8 << 20, "dnarc": 4 << 20}


def rc_encode(family: str, data: bytes) -> bytes:
    """Adaptive range coder, family in {o1rc, o2rc, dnarc}; streams above
    the family block size split into independently coded blocks."""
    buf = np.frombuffer(data, dtype=np.uint8)
    nb = max(1, -(-len(buf) // _RC_BLOCK[family]))
    cap = len(buf) + len(buf) // 4 + 64 + 12 + 8 * nb
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = _load().rc_encode_blocked(_RC_FAMILY[family], buf.ctypes.data,
                                      len(buf), _RC_BLOCK[family],
                                      out.ctypes.data, cap)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 4  # adversarial input can expand; retry with more room


def rc_decode(family: str, data: bytes, raw_len: int) -> bytes:
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(raw_len, dtype=np.uint8)
    r = _load().rc_decode_blocked(_RC_FAMILY[family], buf.ctypes.data,
                                  len(buf), out.ctypes.data, raw_len)
    if r != raw_len:
        raise ValueError(f"{family}: corrupt blocked stream")
    return out.tobytes()


def dz_encode(data: bytes) -> bytes:
    """Base-level LZ + blocked dnarc literals for packed-DNA streams."""
    buf = np.frombuffer(data, dtype=np.uint8)
    cap = len(buf) + len(buf) // 2 + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = _load().dz_encode(buf.ctypes.data, len(buf), out.ctypes.data, cap)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 4


def dz_decode(data: bytes, raw_len: int) -> bytes:
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(raw_len, dtype=np.uint8)
    r = _load().dz_decode(buf.ctypes.data, len(buf), out.ctypes.data, raw_len)
    if r != raw_len:
        raise ValueError("dz: corrupt stream")
    return out.tobytes()


def dz_encode_parts(data: bytes) -> tuple[bytes, int, bytes]:
    """The dz matcher alone (codec "dzt"): (token planes, 12 bytes per
    token; the token count; 2-bit-packed literal bases), not entropy
    coded."""
    buf = np.frombuffer(data, dtype=np.uint8)
    tok_cap = 12 * (len(buf) * 4 // 32 + 2)
    lit_cap = len(buf) + 8
    tok = np.empty(tok_cap, np.uint8)
    lit = np.empty(lit_cap, np.uint8)
    nt, nlit = ctypes.c_int64(), ctypes.c_int64()
    r = _load().dz_encode_parts(buf.ctypes.data, len(buf), tok.ctypes.data,
                                tok_cap, lit.ctypes.data, lit_cap,
                                ctypes.byref(nt), ctypes.byref(nlit))
    if r < 0:
        raise RuntimeError("dz_encode_parts: output buffers too small")
    return tok[:12 * nt.value].tobytes(), nt.value, lit[:nlit.value].tobytes()


def dz_decode_parts(tok: bytes, nt: int, lit_packed: bytes,
                    raw_len: int) -> bytes:
    """Inverse of dz_encode_parts. Raises ValueError unless
    len(tok) == 12 * nt: the native side reads that many bytes."""
    if len(tok) != 12 * nt:
        raise ValueError(f"dzt: {len(tok)} token bytes for {nt} tokens")
    tb = np.frombuffer(tok, np.uint8)
    lb = np.frombuffer(lit_packed, np.uint8)
    out = np.empty(raw_len, np.uint8)
    r = _load().dz_decode_parts(tb.ctypes.data, nt, lb.ctypes.data, len(lb),
                                out.ctypes.data, raw_len)
    if r != raw_len:
        raise ValueError("dzt: corrupt stream")
    return out.tobytes()


def score_overlaps(ref_flat: np.ndarray, ref_ptr: np.ndarray,
                   a: np.ndarray, b: np.ndarray, d: np.ndarray,
                   cap: int) -> np.ndarray:
    """match_pro mismatch scores for merge candidate pairs."""
    n = len(a)
    out = np.empty(n, np.int32)
    if n:
        ref_flat = _as_c(ref_flat)
        ref_ptr = np.ascontiguousarray(ref_ptr, np.int64)
        a = np.ascontiguousarray(a, np.int64)
        b = np.ascontiguousarray(b, np.int64)
        d = np.ascontiguousarray(d, np.int64)
        _load().score_overlaps(ref_flat.ctypes.data, ref_ptr.ctypes.data,
                               a.ctypes.data, b.ctypes.data, d.ctypes.data,
                               n, cap, out.ctypes.data)
    return out


def consensus_host(codes_sub: np.ndarray, rid2d: np.ndarray, col: np.ndarray,
                   segptr: np.ndarray, colptr: np.ndarray, span: int,
                   want_ref: bool, want_diffs: bool):
    """Segmented majority-vote consensus + member diffs on the host
    (consensus.cpp). A test oracle of the consensus kernel: the pipeline
    never calls it. Returns (ref[span] uint8 or None, diffs[M] int32 or
    None)."""
    codes_sub = _as_c(codes_sub)
    rid2d = np.ascontiguousarray(rid2d, np.int32)
    col = np.ascontiguousarray(col, np.int64)
    segptr = np.ascontiguousarray(segptr, np.int64)
    colptr = np.ascontiguousarray(colptr, np.int64)
    M = len(rid2d)
    ref = np.empty(span, np.uint8)
    diffs = np.empty(M, np.int32) if want_diffs else np.empty(0, np.int32)
    want = (1 if want_ref else 0) | (2 if want_diffs else 0)
    _load().consensus_host(codes_sub.ctypes.data, codes_sub.shape[0],
                           codes_sub.shape[1], rid2d.ctypes.data,
                           col.ctypes.data, M, segptr.ctypes.data,
                           colptr.ctypes.data, len(segptr) - 1, span, want,
                           ref.ctypes.data, diffs.ctypes.data)
    return (ref if want_ref else None), (diffs if want_diffs else None)


def sketch_windowed_host(ref_flat: np.ndarray, starts: np.ndarray,
                         rlens: np.ndarray, k: int, we_row: np.ndarray,
                         mcap_row: np.ndarray, m_max: int):
    """Windowed-minimizer sketch of rows at (start, len) into ref_flat on
    the host (sketch.cpp). A test oracle of the contig sketch kernel.
    Returns (key32 [R, m_max] u32, meta [R, m_max] i32, nv [R] i32)."""
    n_rows = len(starts)
    ref_flat = _as_c(ref_flat)
    starts = np.ascontiguousarray(starts, np.int64)
    rlens = np.ascontiguousarray(rlens, np.int32)
    we_row = np.ascontiguousarray(we_row, np.int32)
    mcap_row = np.ascontiguousarray(mcap_row, np.int32)
    key = np.zeros((n_rows, m_max), np.uint32)
    meta = np.zeros((n_rows, m_max), np.int32)
    nv = np.zeros(n_rows, np.int32)
    if n_rows:
        _load().sketch_windowed_host(
            ref_flat.ctypes.data, starts.ctypes.data, rlens.ctypes.data,
            n_rows, int(k), we_row.ctypes.data, mcap_row.ctypes.data,
            int(m_max), key.ctypes.data, meta.ctypes.data, nv.ctypes.data)
    return key, meta, nv


def sketch_reads_host(codes: np.ndarray, rids: np.ndarray, k: int):
    """Whole-read canonical minimizer of codes[rids] on the host
    (sketch.cpp). A test oracle of the read sketch kernel. Returns
    (kmer_hi u32, kmer_lo u32, end_pos i32, strand i8)."""
    codes = _as_c(codes)
    rids = np.ascontiguousarray(rids, np.int64)
    n = len(rids)
    hi = np.empty(n, np.uint32)
    lo = np.empty(n, np.uint32)
    pos = np.empty(n, np.int32)
    strand = np.empty(n, np.int8)
    if n:
        _load().sketch_reads_host(codes.ctypes.data, codes.shape[1],
                                  rids.ctypes.data, n, int(k), hi.ctypes.data,
                                  lo.ctypes.data, pos.ctypes.data,
                                  strand.ctypes.data)
    return hi, lo, pos, strand


def popcounts_at(codes: np.ndarray, rids: np.ndarray):
    """(pop_vs_allA, pop_vs_allT) int32 2-bit XOR popcounts of codes[rids]."""
    codes = _as_c(codes)
    rids = np.ascontiguousarray(rids, np.int64)
    n = len(rids)
    pa = np.empty(n, np.int32)
    pt = np.empty(n, np.int32)
    if n:
        _load().popcounts_at(codes.ctypes.data, codes.shape[1],
                             rids.ctypes.data, n, pa.ctypes.data,
                             pt.ctypes.data)
    return pa, pt


def probe_index_pairs(ikey, icid, ipos, istrand, pkey, pcid, ppos, pstrand,
                      cap: int):
    """Merge candidate join: probes walk the per-key index buckets (array
    order, first ``cap`` per probe), emitting (a, b, shift) for
    different-contig same-strand hits. Returns (a, b, d, drops)."""
    ikey = np.ascontiguousarray(ikey, np.uint32)
    icid = np.ascontiguousarray(icid, np.int64)
    ipos = np.ascontiguousarray(ipos, np.int32)
    istrand = np.ascontiguousarray(istrand, np.int8)
    pkey = np.ascontiguousarray(pkey, np.uint32)
    pcid = np.ascontiguousarray(pcid, np.int64)
    ppos = np.ascontiguousarray(ppos, np.int32)
    pstrand = np.ascontiguousarray(pstrand, np.int8)
    drops = np.zeros(1, np.int64)
    out_cap = max(1 << 16, len(pkey) * 2)
    while True:
        a = np.empty(out_cap, np.int64)
        b = np.empty(out_cap, np.int64)
        d = np.empty(out_cap, np.int64)
        n = _load().probe_index_pairs(
            ikey.ctypes.data, icid.ctypes.data, ipos.ctypes.data,
            istrand.ctypes.data, len(ikey),
            pkey.ctypes.data, pcid.ctypes.data, ppos.ctypes.data,
            pstrand.ctypes.data, len(pkey),
            int(cap), drops.ctypes.data,
            a.ctypes.data, b.ctypes.data, d.ctypes.data, out_cap)
        if n >= 0:
            return a[:n], b[:n], d[:n], int(drops[0])
        out_cap = -n


def set_threads(n: int) -> None:
    """Cap the native OpenMP worker count (the -t flag; results do not
    depend on the thread count)."""
    if n > 0:
        _load().set_num_threads(int(n))


def fastq_parse_codes(data: bytes) -> np.ndarray:
    """FASTQ buffer -> [N, L] base-code matrix. Raises ValueError on a
    truncated record structure, non-uniform length or L > 256."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    n_reads = ctypes.c_int64()
    L = ctypes.c_int64()
    rc = lib.fastq_scan(buf.ctypes.data, len(buf),
                        ctypes.byref(n_reads), ctypes.byref(L))
    if rc == -1:
        raise ValueError("truncated FASTQ (line count not a multiple of 4)")
    if rc == -2:
        raise ValueError("reads have non-uniform length")
    if rc == -3:
        raise ValueError("read length exceeds the 256 bp limit")
    out = np.empty((n_reads.value, L.value), dtype=np.uint8)
    if n_reads.value:
        lib.fastq_extract(buf.ctypes.data, len(buf), n_reads.value, L.value,
                          out.ctypes.data)
    return out


def realign_probe(ref_flat: np.ndarray, ref_ptr: np.ndarray,
                  sg_codes: np.ndarray, dict_starts: np.ndarray,
                  seg_len: int, thr: int, max_search: int,
                  rc_skip_cost: bool):
    """Native realign probe (realign.cpp): winner arrays (sg_idx, contig,
    offset, dir, popcount), the best placement per singleton under the claim
    order (pop, contig, offset, dir), at most one row per singleton, in
    singleton order."""
    n_sg, L = sg_codes.shape
    ref_flat = _as_c(ref_flat)
    ref_ptr = np.ascontiguousarray(ref_ptr, np.int64)
    sg_codes = _as_c(sg_codes)
    dict_starts = np.ascontiguousarray(dict_starts, np.int32)
    cap = max(1, n_sg)
    out = [np.empty(cap, np.int32), np.empty(cap, np.int32),
           np.empty(cap, np.int32), np.empty(cap, np.int8),
           np.empty(cap, np.int32)]
    n = _load().realign_probe(
        ref_flat.ctypes.data, ref_ptr.ctypes.data, len(ref_ptr) - 1,
        sg_codes.ctypes.data, n_sg, L,
        dict_starts.ctypes.data, seg_len, len(dict_starts),
        thr, max_search, int(rc_skip_cost),
        out[0].ctypes.data, out[1].ctypes.data, out[2].ctypes.data,
        out[3].ctypes.data, out[4].ctypes.data, cap)
    if n < 0:
        raise RuntimeError("realign_probe failed")
    return tuple(o[:n] for o in out)
