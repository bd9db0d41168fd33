"""FASTQ ingestion (reference: bseq.c/kseq.h): the sequence lines of a
fixed-length FASTQ, optionally gzipped, as an [N, L] base-code matrix
(A=0, C=1, G=2, T=3, anything else 4), parsed by native code; and the
writer of decoded lines matrices."""

from __future__ import annotations

import gzip

import numpy as np

from minicom_tpu_torch import native


def _read_all(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.open(f, "rb").read()
        return f.read()


def read_fastq_codes(path: str) -> np.ndarray:
    """FASTQ -> [N, L] uint8 base codes, the pipeline's read store.

    Raises ValueError on a truncated record structure, non-uniform read
    length (the reference aborts, bseq.c:54-57) or L > 256."""
    data = _read_all(path)
    if data and not data.endswith(b"\n"):
        data += b"\n"
    try:
        return native.fastq_parse_codes(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def write_lines(path: str, lines_mat: np.ndarray) -> None:
    """Write an [N, L+1] matrix whose last column is already '\\n' (built by
    pipeline.decode): pure I/O, no copy."""
    with open(path, "wb") as f:
        if lines_mat.size:                # empty views cannot cast
            f.write(memoryview(lines_mat).cast("B"))
