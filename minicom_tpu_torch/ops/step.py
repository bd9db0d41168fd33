"""The fused cluster step: one whole clustering round over an [N, L] batch,
the data kept on its device from the reads to the votes.

Replaces ``minicom_tpu/ops/step.py::cluster_step``, the JAX package's
single-dispatch "forward step": each read's canonical minimizer (the first
minimum of the k-mer ranks), a stable sort on the 62-bit k-mer, segments of
equal k-mers (both strands of one canonical k-mer share a segment), members
aligned by their mirrored minimizer position against the segment's
largest, a majority vote over a flat column space in which segment g owns
columns [g 2L, g 2L + 2L), coverage, and each member's mismatch count.

``cluster_step`` runs the plain PyTorch version below on a CPU tensor. On a
CUDA tensor it launches kernel (c) (``mtc_sketch_reads``, the cluster
rounds' read minimizer) on an arange of rids, then the three kernels of
``csrc/step.cu`` with one ``torch.sort`` between the first two: no host
plan, no sync, and the segment count stays on the card. Each kernel has its
plain version here (``_keys_plain``, ``_segments_plain``, ``_vote_plain``);
``_cluster_step_plain`` is the whole step from ``_kmers``, ``torch.sort``
and ``bincount``.
"""

from __future__ import annotations

import torch

from minicom_tpu_torch.ops import cuda, sketch
from minicom_tpu_torch.ops.sketch import U32_MAX, _kmers

L_MAX = sketch.L_MAX   # on the card: kernel (c) stages rows of <= 256
COL_MAX = (1 << 31) - 1   # columns are int32, as in the JAX program
# The most columns of a vote tile: 16 bytes of counts a column, so a tile of
# ~25 KB lets eight 256-thread blocks share an SM.
TILE_COLS = 1536
SEG_ROWS = 8   # rows of 32 items a warp of the segment scan (csrc/step.cu)
SEG_TILE = 8 * 32 * SEG_ROWS   # items a tile: 8 warps


def seg_scratch_words(N: int) -> int:
    """int32 words of ``mtc_step_segments``' scratch for N items: a 64-bit
    status word a tile of SEG_TILE items, then the tiles' ticket. The entry
    zeroes it on the stream, so one buffer serves any number of calls (a
    CUDA graph's replays too)."""
    return 2 * (-(-N // SEG_TILE) + 1)


def tile_slots(L: int) -> int:
    """G, the segment slots of a vote tile: as many as fit TILE_COLS
    columns, at least 2, with G 2L a multiple of 4 (the tiles' columns
    start 4-aligned)."""
    g = max(2, TILE_COLS // (2 * L))
    return g - (g * L) % 2


def _check(N: int, L: int, k: int, span_cols: int) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside [1, 31]")
    if L < k:
        raise ValueError(f"reads of {L} bases are shorter than k={k}")
    if N < 1 or span_cols < 1:
        raise ValueError(f"want reads and columns, got N={N}, "
                         f"span_cols={span_cols}")
    if N * 2 * L > COL_MAX:
        raise ValueError(f"{N} reads of {L} bases need {N * 2 * L} columns, "
                         f"more than the int32 columns' {COL_MAX}")


def _mz(pos, z, L, k):
    """mpos << 1 | strand: the minimizer's end position, mirrored on
    strand 1."""
    return (torch.where(z == 1, L - pos + k - 2, pos) * 2 + z).to(
        torch.int32)


def _minimizers_plain(codes, k):
    """(key int64, mz int32) of each read from all its k-mers: the first
    minimum of the ranks (palindromes rank last), as the JAX argmin."""
    N, L = codes.shape
    h, canon, strand, pal = _kmers(codes.to(torch.int64), k)
    h = torch.where(pal, U32_MAX, h)
    S = L - k + 1
    s = (h * S + torch.arange(S, device=codes.device)).argmin(1, True)
    return canon.gather(1, s)[:, 0], _mz(s[:, 0] + k - 1,
                                         strand.gather(1, s)[:, 0].long(), L,
                                         k)


def _keys_plain(codes, sk, k):
    """The plain version of ``mtc_step_keys``: (key, mz) from kernel (c)'s
    [3, N] words (u32 values in any integer type). A read with no chosen
    k-mer (third word 0) takes its k-mer at start 0."""
    L = codes.shape[1]
    hi, lo, meta = sk.to(torch.int64) & U32_MAX
    _, canon0, strand0, _ = _kmers(codes[:, :k].to(torch.int64), k)
    none = meta == 0
    key = torch.where(none, canon0[:, 0], hi << 32 | lo)
    pos = torch.where(none, k - 1, meta >> 1)
    z = torch.where(none, strand0[:, 0].long(), meta & 1)
    return key, _mz(pos, z, L, k)


def _segments_plain(skey, order, mz):
    """The plain version of ``mtc_step_segments``: (order int32, smz = mz
    in sorted order, seg_id, first [nseg + 1] (each segment's first member,
    then N), seg_max [nseg] (each segment's largest mpos))."""
    head = torch.ones_like(skey, dtype=torch.bool)
    head[1:] = skey[1:] != skey[:-1]
    seg_id = head.cumsum(0) - 1
    smz = mz[order]
    first = torch.nonzero(head)[:, 0]
    seg_max = torch.zeros(len(first), dtype=torch.int64, device=skey.device)
    seg_max.scatter_reduce_(0, seg_id, (smz >> 1).long(), "amax")
    first = torch.cat([first, first.new_full((1,), len(skey))])
    return (order.to(torch.int32), smz, seg_id.to(torch.int32),
            first.to(torch.int32), seg_max.to(torch.int32))


def _vote_plain(codes, order, smz, seg_id, seg_max, span):
    """The plain version of ``mtc_step_vote``: (consensus [span] uint8,
    coverage [span] int32, diffs [N] int32) of the sorted members. Columns
    at or past ``span`` count for nothing and read 255."""
    L = codes.shape[1]
    dev = codes.device
    rows = codes[order.long()].to(torch.int64)
    rc = torch.where(rows < 4, 3 - rows, rows).flip(1)
    oriented = torch.where((smz & 1).bool()[:, None], rc, rows)
    sid = seg_id.long()
    off = seg_max.long()[sid] - (smz >> 1).long()
    cols = (sid * 2 * L + off)[:, None] + torch.arange(L, device=dev)
    ok = (cols < span) & (oriented < 4)
    counts = torch.bincount((cols * 4 + oriented)[ok],
                            minlength=span * 4).view(span, 4)
    best = torch.zeros(span, dtype=torch.int64, device=dev)
    top = counts[:, 0]
    for b in (1, 2, 3):   # the first maximum: ties to the lowest code
        better = counts[:, b] > top
        best = torch.where(better, b, best)
        top = torch.where(better, counts[:, b], top)
    ref_at = torch.where(cols < span, best[cols.clamp(max=span - 1)], 255)
    return (best.to(torch.uint8), counts.sum(1).to(torch.int32),
            (ref_at != oriented).sum(1, dtype=torch.int32))


def _cluster_step_plain(codes, k, span_cols):
    key, mz = _minimizers_plain(codes, k)
    skey, order = torch.sort(key, stable=True)
    order32, smz, seg_id, _, seg_max = _segments_plain(skey, order, mz)
    consensus, coverage, diffs = _vote_plain(codes, order32, smz, seg_id,
                                             seg_max, span_cols)
    return consensus, coverage, diffs, seg_id, order32


def _keys(codes, sk, k):
    """One launch of ``mtc_step_keys``: (key [N] int64, mz [N] int32)."""
    N, L = codes.shape
    key = torch.empty(N, dtype=torch.int64, device=codes.device)
    mz = torch.empty(N, dtype=torch.int32, device=codes.device)
    cuda.launch("mtc_step_keys", codes, L, sk, N, k, key, mz)
    return key, mz


def _segments(skey, order, mz):
    """One launch of ``mtc_step_segments``: (order int32, smz, seg_id, first
    [N + 2] (first[0 .. nseg] as ``_segments_plain``'s, nseg at N + 1),
    seg_max [N] (0 .. nseg - 1 written))."""
    N = len(skey)
    words = seg_scratch_words(N)   # first in the buffer: 8-byte aligned
    buf = torch.empty(words + 5 * N + 2, dtype=torch.int32,
                      device=skey.device)
    scratch, order32, smz, seg_id, first, seg_max = buf.split(
        [words, N, N, N, N + 2, N])
    cuda.launch("mtc_step_segments", skey, order, mz, N, scratch, order32,
                smz, seg_id, first, seg_max)
    return order32, smz, seg_id, first, seg_max


def _vote(codes, order, smz, seg_id, first, seg_max, span):
    """One launch of ``mtc_step_vote``: (consensus, coverage, diffs)."""
    N, L = codes.shape
    dev = codes.device
    consensus = torch.empty(span, dtype=torch.uint8, device=dev)
    coverage = torch.empty(span, dtype=torch.int32, device=dev)
    diffs = torch.empty(N, dtype=torch.int32, device=dev)
    cuda.launch("mtc_step_vote", codes, L, order, smz, seg_id, first,
                seg_max, N, tile_slots(L), span, consensus, coverage, diffs)
    return consensus, coverage, diffs


def cluster_step(codes: torch.Tensor, k: int, span_cols: int):
    """One clustering round over ``codes`` [N, L] uint8 (codes 0..3, N
    substituted), on the tensor's device.

    Returns (consensus [span_cols] uint8, coverage [span_cols] int32, diffs
    [N] int32, seg_id [N] int32, order [N] int32): the flat consensus
    column space (segment g's columns from g 2L; a column at or past
    span_cols is dropped, and a member's base there counts as a mismatch),
    each sorted member's mismatches against its segment's consensus, each
    sorted member's segment and the sort permutation. Exactly
    ``minicom_tpu.ops.step.cluster_step``'s outputs.

    ValueError for k outside [1, 31], L < k, no reads or columns, more than
    2^31 - 1 columns (N 2L), and on the card L > 256. On the card: kernel
    (c), ``mtc_step_keys``, ``torch.sort``, ``mtc_step_segments`` and
    ``mtc_step_vote``, one launch each and no sync."""
    cuda.check(codes, torch.uint8, 2, "codes")
    N, L = codes.shape
    _check(N, L, k, span_cols)
    if codes.device.type == "cpu":
        return _cluster_step_plain(codes, k, span_cols)
    cuda.require_cuda(codes)
    if L > L_MAX:
        raise ValueError(f"reads of {L} bases: the card takes at most "
                         f"{L_MAX}")
    rids = torch.arange(N, dtype=torch.int32, device=codes.device)
    key, mz = _keys(codes, sketch.sketch_reads_device(codes, rids, k), k)
    skey, order = torch.sort(key, stable=True)
    order32, smz, seg_id, first, seg_max = _segments(skey, order, mz)
    consensus, coverage, diffs = _vote(codes, order32, smz, seg_id, first,
                                       seg_max, span_cols)
    return consensus, coverage, diffs, seg_id, order32
