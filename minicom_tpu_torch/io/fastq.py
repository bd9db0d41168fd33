"""FASTQ ingestion (reference: bseq.c/kseq.h): the sequence lines of a
fixed-length FASTQ, optionally gzipped, as an [N, L] base-code matrix
(A=0, C=1, G=2, T=3, anything else 4), parsed by native code; and the
writer of decoded lines matrices.

In a multi-process run each rank parses only its byte-range slice of a plain
file, snapped to record boundaries through an ordered exchange of per-slice
line counts. A gzip stream cannot be read from the middle, so every rank
parses it whole and keeps its slice. A parse error on one rank is reported
in the exchange that follows, so every rank raises the same ValueError."""

from __future__ import annotations

import gzip
import os

import numpy as np

from minicom_tpu_torch import native
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.parallel.store import ShardedReadStore, maybe_shard


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _read_all(path: str) -> bytes:
    if _is_gzip(path):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _parse_codes(data: bytes, path: str) -> np.ndarray:
    try:
        return native.fastq_parse_codes(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def read_fastq_codes(path: str) -> np.ndarray:
    """FASTQ -> [N, L] uint8 base codes, parsed by this process alone.

    Raises ValueError on a truncated record structure, non-uniform read
    length (the reference aborts, bseq.c:54-57) or L > 256."""
    data = _read_all(path)
    if data and not data.endswith(b"\n"):
        data += b"\n"
    return _parse_codes(data, path)


def read_fastq_store(path: str):
    """FASTQ -> the pipeline's read store: the [N, L] matrix in a
    single-process run, a ShardedReadStore in a group (each rank KEEPS only
    its parse slice)."""
    if dist.process_grid()[1] == 1:
        return read_fastq_codes(path)
    if _is_gzip(path):
        return maybe_shard(read_fastq_codes(path))
    local, counts = _parse_slice_agreed(path)
    bounds = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts[:, 0], out=bounds[1:])
    return ShardedReadStore(local, bounds)


def read_fastq_full(path: str) -> np.ndarray:
    """FASTQ -> the whole [N, L] matrix on every rank (the two files of a
    paired-end run): in a group, plain files are parsed in byte-range slices
    and the slices all-gathered."""
    if dist.process_grid()[1] == 1 or _is_gzip(path):
        return read_fastq_codes(path)
    local, counts = _parse_slice_agreed(path)
    L = int(counts[counts[:, 0] > 0, 1].max(initial=0))
    allc = dist.allgather_ragged(local.reshape(-1))
    return allc.reshape(-1, L) if L else np.zeros((0, 0), np.uint8)


def _parse_slice_agreed(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(this rank's [n_i, L] slice, [P, 2] per-rank (n_i, L_i)); raises the
    same ValueError on every rank if any slice failed to parse or the slices
    disagree on L. COLLECTIVE."""
    try:
        local, err = _parse_slice(path), None
    except ValueError as e:
        local, err = np.zeros((0, 0), np.uint8), str(e)
    msg = np.frombuffer((err or "").encode(), np.uint8)
    # the shape exchange carries the failure: L = -1 and the message
    shape = np.array([local.shape[0], -1 if err else local.shape[1],
                      len(msg)], np.int64)
    shapes, msgs = dist.allgather_ragged_many([shape, msg])
    shapes = shapes.reshape(-1, 3)
    bad = np.flatnonzero(shapes[:, 1] < 0)
    if len(bad):
        start = int(shapes[:bad[0], 2].sum())
        raise ValueError(msgs[start:start + shapes[bad[0], 2]].tobytes()
                         .decode(errors="replace"))
    Ls = shapes[shapes[:, 0] > 0, 1]
    if len(Ls) and not np.all(Ls == Ls[0]):
        raise ValueError(f"{path}: reads have non-uniform length")
    if local.shape[0] == 0 and len(Ls):
        local = local.reshape(0, int(Ls[0]))
    return np.ascontiguousarray(local), shapes[:, :2]


def _parse_slice(path: str) -> np.ndarray:
    """Parse THIS rank's byte-range slice of a plain FASTQ into [n_i, L]
    codes (record-boundary snapping via an ordered line-count exchange, so
    every rank calls it)."""
    pid, nproc = dist.process_grid()
    size = os.path.getsize(path)
    lo = size * pid // nproc
    hi = size * (pid + 1) // nproc
    with open(path, "rb") as f:
        at_start = lo == 0
        if not at_start:
            f.seek(lo - 1)
            at_start = f.read(1) == b"\n"  # a line starts exactly at lo
        buf = np.frombuffer(f.read(hi - lo), np.uint8)
    # global line parity: exchange per-slice newline counts so each rank
    # knows the global line index at its slice start (records = 4 lines)
    nl = np.flatnonzero(buf == ord("\n"))
    counts = dist.allgather_ragged(np.array([len(nl)], np.int64))
    first_line = int(counts[:pid].sum())
    # line starts within the slice (byte offsets, slice-relative) and their
    # global line indices (= number of '\n' before the start byte)
    if at_start:
        starts = np.concatenate([[0], nl + 1])
        line_of = first_line + np.arange(len(starts))
    else:
        starts = nl + 1
        line_of = first_line + 1 + np.arange(len(starts))
    rec = starts[line_of % 4 == 0]
    rec = rec[rec < len(buf)]  # a start at the slice end belongs to the next rank
    if len(rec) == 0:
        return np.zeros((0, 0), np.uint8)
    r0 = int(rec[0])
    # records starting in this slice may end past hi: a record is 4 lines,
    # so finish the open one from the next bytes of the file. A line cut
    # at hi is one more line to finish, and where it starts a record
    # (done a multiple of 4) that whole record is this slice's
    done = int((nl >= r0).sum())  # complete lines from r0 to slice end
    cut = int(buf[-1] != ord("\n"))
    need = -(-(done + cut) // 4) * 4 - done
    tail = b""
    if need:
        with open(path, "rb") as f:
            f.seek(hi)
            tail = f.read(1 << 20)
        t = np.frombuffer(tail, np.uint8)
        tnl = np.flatnonzero(t == ord("\n"))
        if len(tnl) >= need:
            tail = tail[: int(tnl[need - 1]) + 1]
        elif hi + len(tail) == size and len(tnl) == need - 1:
            tail += b"\n"  # unterminated final line at EOF
        else:
            raise ValueError(f"{path}: truncated FASTQ at EOF")
    my_records = buf[r0:].tobytes() + tail
    if not my_records.endswith(b"\n") and hi == size:
        my_records += b"\n"
    return _parse_codes(my_records, path)


def write_lines(path: str, lines_mat: np.ndarray) -> None:
    """Write an [N, L+1] matrix whose last column is already '\\n' (built by
    pipeline.decode): pure I/O, no copy."""
    with open(path, "wb") as f:
        if lines_mat.size:                # empty views cannot cast
            f.write(memoryview(lines_mat).cast("B"))
