"""Decompressor (reference: decompress.c).

Reverses ``pipeline.encode.serialize``: a cluster's consensus length is its
last member position + readlen, so per-cluster ref extents are a prefix sum
and the member reads come from one native diff-decode pass per row chunk.

Output assembly by mode (decompress.c:1225-1317):
* unordered: canonical emission order (allA, allT, allN, AA, TT, NN,
  single_N, single, cluster members), a permutation of the input multiset.
* ORDER: every read is placed at its input index via the id streams.
* PE: file bit 0 -> append to the mate-1 output; bit 1 -> place at slot
  ``peid`` of the mate-2 output, so line i of file 2 is the mate of line i
  of file 1.
Host work only. In a multi-process run the cluster member rows are decoded
in rank ranges and exchanged, so every rank assembles the whole output.
"""

from __future__ import annotations

import ctypes
import mmap
import threading

import numpy as np

from minicom_tpu_torch import native
from minicom_tpu_torch.ops.pack import (codes_to_ascii, unpack_2bit,
                                        unpack_bits)
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.pipeline.encode import DPOS_ESCAPE
from minicom_tpu_torch.stats import substage as _sub


def _unpack_cluster_reads(meta: dict, streams: dict, out: np.ndarray,
                          sink) -> None:
    """Decode all cluster member reads into ``out`` ([M, L] ASCII rows),
    calling ``sink(lo, hi)`` per finished row chunk."""
    L = meta["readlen"]
    M = meta["n_members"]
    if M == 0:
        return
    base, dirs8, ref_total = native.decode_cluster_meta(
        np.frombuffer(streams["cnt"], np.uint32),
        np.frombuffer(streams["dpos"], np.uint16),
        np.frombuffer(streams["dposx"], np.uint32),
        np.frombuffer(streams["dir"], np.uint8), M, L, DPOS_ESCAPE)
    ref_cat = unpack_2bit(np.frombuffer(streams["ref"], np.uint8), ref_total)
    buf = np.frombuffer(streams["diff"], np.uint8)
    nl = np.flatnonzero(buf == ord("\n"))
    if len(nl) < M:
        raise ValueError("diff stream has fewer lines than members")
    if dist.process_grid()[1] > 1:
        _unpack_sharded(streams["diff"], nl, ref_cat, base, dirs8, L, out)
        sink(0, M)
        return
    CH = 1 << 20
    for lo in range(0, M, CH):
        hi = min(lo + CH, M)
        s_lo = 0 if lo == 0 else int(nl[lo - 1]) + 1
        s_hi = int(nl[hi - 1]) + 1
        native.diff_decode_win(streams["diff"][s_lo:s_hi], ref_cat,
                               base[lo:hi], dirs8[lo:hi], hi - lo, L,
                               out[lo:hi])
        sink(lo, hi)


def _unpack_sharded(diff: bytes, nl: np.ndarray, ref_cat: np.ndarray,
                    base: np.ndarray, dirs8: np.ndarray, L: int,
                    out: np.ndarray) -> None:
    """Multi-process member decode: each rank decodes a contiguous row
    range (its diff text cut at the range's newlines), and the rows are
    exchanged in rounds of ~64 MB per process into ``out`` on every rank
    (one whole-output gather would add P x the output to each rank's
    peak)."""
    M = len(base)
    _, nproc = dist.process_grid()
    bnds = dist.partition(np.ones(M, np.int32))
    d0, d1 = dist.my_partition(np.ones(M, np.int32))
    my = np.empty((d1 - d0, L), np.uint8)
    err = None
    if d1 > d0:
        t_lo = 0 if d0 == 0 else int(nl[d0 - 1]) + 1
        try:
            native.diff_decode_win(diff[t_lo:int(nl[d1 - 1]) + 1], ref_cat,
                                   base[d0:d1], dirs8[d0:d1], d1 - d0, L, my)
        except ValueError as e:   # a corrupt range: every rank raises
            err = str(e)
    dist.raise_together(err)
    CH = max(1, (64 << 20) // (L * nproc))
    rounds = max(-(-(p1 - p0) // CH) for p0, p1 in bnds)
    for r in range(rounds):
        lo = min(d0 + r * CH, d1)
        blk = dist.allgather_ragged(
            my[lo - d0:min(lo + CH, d1) - d0].reshape(-1)).reshape(-1, L)
        # the r-th chunk of every rank, in rank order
        pos = 0
        for p0, p1 in bnds:
            plo = min(p0 + r * CH, p1)
            phi = min(plo + CH, p1)
            out[plo:phi] = blk[pos:pos + phi - plo]
            pos += phi - plo


def _const_reads(char: bytes, n: int, L: int) -> np.ndarray:
    return np.full((n, L), char[0], np.uint8)


def _iter_class_blocks(meta: dict, streams: dict, stats: dict | None):
    """Yield the [*, L] uint8 ASCII blocks of the special classes in
    canonical emission order, one at a time, so peak memory stays ~1 block
    + output."""
    L = meta["readlen"]
    yield _const_reads(b"A", meta["n_alla"], L)
    yield _const_reads(b"T", meta["n_allt"], L)
    yield _const_reads(b"N", meta["n_alln"], L)
    for key, char in (("aa", b"A"), ("tt", b"T"), ("nn", b"N")):
        with _sub(stats, "decode_aattnn"):
            blk = native.diff_decode(streams[key],
                                     _const_reads(char, meta[f"n_{key}"], L),
                                     meta[f"n_{key}"])
        yield blk
    ns = np.frombuffer(streams["nsingle"], np.uint8)
    yield (ns.reshape(meta["n_nsingle"], L + 1)[:, :L]
           if meta["n_nsingle"] else np.zeros((0, L), np.uint8))
    with _sub(stats, "decode_single"):
        sg = unpack_2bit(np.frombuffer(streams["single"], np.uint8),
                         meta["n_single"] * L)
        blk = codes_to_ascii(sg.reshape(meta["n_single"], L))
    yield blk


def _hugepage_empty(n: int, L1: int) -> np.ndarray:
    """[n, L1] uint8 backed by an anonymous mmap with MADV_HUGEPAGE: fewer,
    larger page faults when a large output matrix is first touched."""
    size = n * L1
    if size < (8 << 20):
        return np.empty((n, L1), np.uint8)
    buf = mmap.mmap(-1, size)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    ctypes.CDLL(None).madvise(ctypes.c_void_p(addr), ctypes.c_size_t(size),
                              14)  # MADV_HUGEPAGE; advisory, result ignored
    return np.frombuffer(buf, np.uint8).reshape(n, L1)


def _alloc_lines(n: int, L: int) -> np.ndarray:
    """[n, L+1] output-with-newlines matrix, newline column set: decode
    writes rows into its [:, :L] view and the writer dumps it whole."""
    full = _hugepage_empty(n, L + 1)
    full[:, L] = ord("\n")
    return full


class Prealloc:
    """The output-with-newlines matrices ([n_seq, L+1], or two [half, L+1]
    for PE), allocated and first-touched on a background thread while the
    entropy streams decode (the stream decoders release the GIL): by
    assembly time every page is faulted in."""

    def __init__(self, meta: dict):
        rows = [meta["half"]] * 2 if meta.get("pe") else [meta["n_seq"]]
        self._shapes = [(n, meta["readlen"]) for n in rows]
        self._full = []
        self._err = None
        self._thread = threading.Thread(target=self._build, daemon=True)
        self._thread.start()

    def _build(self):
        try:
            for n, L in self._shapes:
                full = _hugepage_empty(n, L + 1)
                # touch one byte per 4 KiB page: faults + kernel zeroing now
                if n:
                    full[::max(1, 4096 // (L + 1)), 0] = 0
                self._full.append(full)
        except BaseException as e:   # re-raised on take()
            self._err = e

    def take(self) -> list:
        """Blocks until allocation finishes; returns the lines matrices with
        their newline column set."""
        self._thread.join()
        if self._err is not None:
            raise self._err
        for (_, L), full in zip(self._shapes, self._full):
            full[:, L] = ord("\n")
        return self._full


def assemble_unordered(meta: dict, streams: dict, stats: dict | None,
                       pre: Prealloc, sink) -> np.ndarray:
    """Fill the [n_seq, L+1] lines matrix in emission order, handing each
    finished row range to ``sink`` (a writer thread streams it to disk while
    later rows still decode). Returns the matrix."""
    full = pre.take()[0]
    n_seq, L, M = meta["n_seq"], meta["readlen"], meta["n_members"]
    out = full[:, :L]
    pos = 0
    for blk in _iter_class_blocks(meta, streams, stats):
        out[pos:pos + len(blk)] = blk
        sink(full[pos:pos + len(blk)])
        pos += len(blk)
    if pos + M != n_seq:
        raise ValueError("class blocks do not partition the read set")
    # cluster members are the last block: decoded straight into the tail
    with _sub(stats, "decode_clusters"):
        _unpack_cluster_reads(meta, streams, out[pos:],
                              lambda lo, hi: sink(full[pos + lo:pos + hi]))
    return full


def _all_class_blocks(meta: dict, streams: dict, stats: dict | None):
    """The special-class blocks, then the cluster members as one [M, L]
    block."""
    yield from _iter_class_blocks(meta, streams, stats)
    out = np.empty((meta["n_members"], meta["readlen"]), np.uint8)
    with _sub(stats, "decode_clusters"):
        _unpack_cluster_reads(meta, streams, out, lambda lo, hi: None)
    yield out


def _u32_stream(streams: dict, name: str, n: int) -> np.ndarray:
    """Stream ``name`` as n u32 values (int64); raises unless it holds
    exactly n."""
    v = np.frombuffer(streams.get(name, b""), np.uint32).astype(np.int64)
    if len(v) != n:
        raise ValueError(f"{name} stream holds {len(v)} ids, want {n} "
                         "(corrupt archive)")
    return v


def _in_range(name: str, ids: np.ndarray, bound: int) -> np.ndarray:
    if len(ids) and (ids.min() < 0 or ids.max() >= bound):
        raise ValueError(f"{name} ids out of range (corrupt archive)")
    return ids


_ID_STREAMS = (("ids_alla", "n_alla"), ("ids_allt", "n_allt"),
               ("ids_alln", "n_alln"), ("ids_aa", "n_aa"), ("ids_tt", "n_tt"),
               ("ids_nn", "n_nn"), ("ids_nsingle", "n_nsingle"),
               ("ids_single", "n_single"))


def _class_ids(meta: dict, streams: dict) -> list:
    """Input indices of each special class, in emission order: the
    running sums of its delta id stream."""
    return [_in_range(name, np.cumsum(_u32_stream(streams, name, meta[count])),
                      meta["n_seq"])
            for name, count in _ID_STREAMS]


def _cluster_ids(meta: dict, streams: dict) -> np.ndarray:
    """Decode the abs/delta cluster id stream (kthread_dump.c:117-128)."""
    M = meta["n_members"]
    raw = _u32_stream(streams, "ids", M).astype(np.uint32)
    if M == 0:
        return np.zeros(0, np.int64)
    starts = np.cumsum(np.frombuffer(streams["cnt"], np.uint32),
                       dtype=np.int64)[:-1]
    first = np.zeros(M, bool)
    first[0] = True
    first[starts[starts < M]] = True
    d16 = np.frombuffer(streams["dpos"], np.uint16)[:M]
    is_abs = first | (d16 != 0)
    # ids[i] = raw[i] if abs else ids[i-1] + raw[i] (u32 wraparound,
    # kthread_dump.c:121-126): a segmented cumsum anchored at abs entries,
    # out[i] = csum[i] - csum[a] + raw[a] for the latest abs index a <= i
    seg = np.cumsum(is_abs) - 1
    csum = np.cumsum(raw, dtype=np.uint64).astype(np.uint32)
    abs_idx = np.flatnonzero(is_abs)
    ids = (csum - csum[abs_idx][seg] + raw[abs_idx][seg]).astype(np.uint32)
    return _in_range("ids", ids.astype(np.int64), meta["n_seq"])


def assemble_order(meta: dict, streams: dict, stats: dict | None = None,
                   pre: Prealloc | None = None) -> np.ndarray:
    """Every read placed at its input index via the id streams; returns the
    [n_seq, L+1] lines matrix. Class blocks are decoded, scattered into the
    output and dropped one at a time, so peak memory is the output + one
    block."""
    ids = _class_ids(meta, streams) + [_cluster_ids(meta, streams)]
    L = meta["readlen"]
    full = pre.take()[0] if pre else _alloc_lines(meta["n_seq"], L)
    out = full[:, :L]
    placed = 0
    for tgt, blk in zip(ids, _all_class_blocks(meta, streams, stats)):
        out[tgt] = blk
        placed += len(blk)
    if placed != meta["n_seq"]:
        raise ValueError("id streams do not partition the read set "
                         "(corrupt archive)")
    return full


def assemble_pe(meta: dict, streams: dict, stats: dict | None = None,
                pre: Prealloc | None = None) -> tuple[np.ndarray, np.ndarray]:
    """File bit 0 -> append to the mate-1 output in emission order; bit 1 ->
    place at slot peid of the mate-2 output. One class block live at a time,
    tracking the running emission ordinal. Returns the two [half, L+1] lines
    matrices."""
    n_emit, half, L = meta["n_seq"], meta["half"], meta["readlen"]
    fb = np.frombuffer(streams.get("fbits", b""), np.uint8)
    if n_emit != 2 * half or len(fb) != -(-n_emit // 8):
        raise ValueError("fbits stream does not match the read count "
                         "(corrupt archive)")
    fbits = unpack_bits(fb, n_emit).astype(bool)
    if int(fbits.sum()) != half:
        raise ValueError("fbits stream does not split the reads in halves "
                         "(corrupt archive)")
    peids = _in_range("peids", _u32_stream(streams, "peids", half), half)
    full1, full2 = pre.take() if pre else (_alloc_lines(half, L),
                                           _alloc_lines(half, L))
    file1, file2 = full1[:, :L], full2[:, :L]
    pos = n1 = n2 = 0
    for blk in _all_class_blocks(meta, streams, stats):
        m2 = fbits[pos:pos + len(blk)]
        k2 = int(m2.sum())
        file1[n1:n1 + len(blk) - k2] = blk[~m2]
        file2[peids[n2:n2 + k2]] = blk[m2]
        n1 += len(blk) - k2
        n2 += k2
        pos += len(blk)
    if pos != n_emit:
        raise ValueError("class blocks do not partition the read set "
                         "(corrupt archive)")
    return full1, full2
