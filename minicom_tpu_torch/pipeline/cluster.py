"""Cluster formation rounds (reference: kthread_bucket.c).

ONE global sort by (minimizer k-mer, -aligned_pos, rid) per round defines the
clusters as segments of the sorted array; the consensus of every cluster of
a round is one segmented vote (``ops.consensus.consensus_vote_flat``). The
k-decreasing rounds and their stopping rules (new clustered reads < 100;
k-round <= 9; round == R-1) are a host loop mirroring kt_for_bucket's
``last_rounds`` state machine.

The read store lives on the device (uploaded once by the caller); a round
sends the device only its members as (rid, dir, column) int64 triples and
gets back the minimizers, the consensus bytes and the member diffs. The sort
and the segment bookkeeping stay host numpy. In a multi-process run the
store is a ShardedReadStore whose local slice is on each rank's device, and
every rank runs the kernels on its share of the round (``_sketch``,
``consensus_from_members``) and its hash range of the sort.

Aligned positions of reverse-strand reads are mirrored with the ROUND's k
(the reference reuses the initial k, kthread_bucket.c:52,93).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from minicom_tpu_torch.config import ResolvedConfig
from minicom_tpu_torch.ops import cuda
from minicom_tpu_torch.ops.consensus import consensus_vote_flat
from minicom_tpu_torch.ops.sketch import sketch_reads_flat
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.parallel.store import ShardedReadStore


@dataclasses.dataclass
class ClusterSet:
    """CSR cluster store: members + consensus contigs, all flat numpy arrays.

    Member offsets are the column of the ORIENTED read's first base within the
    cluster's consensus (the reference's `pos_0 - pos`,
    kthread_bucket.c:99-101).
    """

    readlen: int
    mem_rid: np.ndarray       # [M] int64
    mem_off: np.ndarray       # [M] int32
    mem_dir: np.ndarray       # [M] int8
    cluster_ptr: np.ndarray   # [C+1] int64
    ref_flat: np.ndarray      # [R] uint8 consensus codes
    ref_ptr: np.ndarray       # [C+1] int64

    @property
    def n_clusters(self) -> int:
        return len(self.cluster_ptr) - 1

    @property
    def n_members(self) -> int:
        return len(self.mem_rid)

    def ref_lengths(self) -> np.ndarray:
        return np.diff(self.ref_ptr)

    def cluster_sizes(self) -> np.ndarray:
        return np.diff(self.cluster_ptr)

    @staticmethod
    def empty(readlen: int) -> "ClusterSet":
        z64 = np.zeros(0, np.int64)
        return ClusterSet(readlen, z64.copy(), np.zeros(0, np.int32),
                          np.zeros(0, np.int8), np.zeros(1, np.int64),
                          np.zeros(0, np.uint8), np.zeros(1, np.int64))

    @staticmethod
    def concat(sets: list["ClusterSet"]) -> "ClusterSet":
        sets = [s for s in sets if s.n_clusters > 0] or sets[:1]
        L = sets[0].readlen
        mem_rid = np.concatenate([s.mem_rid for s in sets])
        mem_off = np.concatenate([s.mem_off for s in sets])
        mem_dir = np.concatenate([s.mem_dir for s in sets])
        ptrs, rptrs, base, rbase = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)], 0, 0
        for s in sets:
            ptrs.append(s.cluster_ptr[1:] + base)
            rptrs.append(s.ref_ptr[1:] + rbase)
            base += s.cluster_ptr[-1]
            rbase += s.ref_ptr[-1]
        ref_flat = np.concatenate([s.ref_flat for s in sets])
        return ClusterSet(L, mem_rid, mem_off, mem_dir,
                          np.concatenate(ptrs), ref_flat, np.concatenate(rptrs))


def consensus_from_members(readlen: int, seg_id: np.ndarray, offsets: np.ndarray,
                           rids: np.ndarray, dirs: np.ndarray,
                           n_segments: int, codes_dev,
                           want_ref: bool = True, want_diffs: bool = True):
    """Batched consensus over CSR-grouped members (seg_id sorted ascending).

    Members are (rid, dir) references into the read store ``codes_dev``:
    the [N, L] device tensor, or a ShardedReadStore. Returns (ref_flat,
    ref_ptr, diffs[M]); consensus span of segment c = max(offset)+L
    (callers rebase offsets to min 0).

    In a multi-process run each rank votes a contiguous range of segments:
    their column spaces are disjoint, so the ranges' consensus and diffs
    all-gather in rank order with no reduction. A sharded store first
    gathers the range's member rows (a collective) and the kernel indexes
    that block."""
    L = readlen
    if len(seg_id) == 0:
        return np.zeros(0, np.uint8), np.zeros(n_segments + 1, np.int64), np.zeros(0, np.int32)
    seg_bounds = np.searchsorted(seg_id, np.arange(n_segments + 1))
    max_off = np.full(n_segments, -1, np.int64)
    np.maximum.at(max_off, seg_id, offsets)
    spans = np.where(np.diff(seg_bounds) > 0, max_off + L, 0)
    ref_ptr = np.zeros(n_segments + 1, np.int64)
    np.cumsum(spans, out=ref_ptr[1:])

    s0, s1 = dist.my_partition(np.diff(seg_bounds))
    m0, m1 = int(seg_bounds[s0]), int(seg_bounds[s1])
    col0, col1 = int(ref_ptr[s0]), int(ref_ptr[s1])
    rids = np.asarray(rids[m0:m1], np.int64)
    codes = codes_dev
    if isinstance(codes_dev, ShardedReadStore):
        codes = cuda.to_device(codes_dev.rows(rids),
                               codes_dev.local_dev.device)
        rids = np.arange(m1 - m0, dtype=np.int64)
    ref, diffs = consensus_vote_flat(
        codes, rids * 2 + dirs[m0:m1],
        ref_ptr[seg_id[m0:m1]] - col0 + offsets[m0:m1],
        seg_bounds[s0:s1 + 1] - m0, ref_ptr[s0:s1 + 1] - col0, col1 - col0,
        want_ref, want_diffs)
    parts = dist.allgather_ragged_many(
        [x for x in (ref, diffs) if x is not None])
    ref = parts.pop(0) if want_ref else None
    diffs = parts.pop(0) if want_diffs else None
    return ref, ref_ptr, diffs


def _sketch(pending: np.ndarray, codes_dev, k: int, L: int):
    """Whole-read minimizer + mirrored (oriented end) position, round-k
    aware. The grouping key is the exact canonical k-mer (uint64).

    With a sharded store each rank sketches the pending reads it owns, on
    its device slice with local rids; the results, all-gathered with their
    pending indices, scatter back into pending order."""
    if isinstance(codes_dev, ShardedReadStore):
        st = codes_dev
        mine = np.flatnonzero((pending >= st.r0) & (pending < st.r1))
        out = sketch_reads_flat(st.local_dev, pending[mine] - st.r0, k)
        idx, *got = dist.allgather_ragged_many([mine, *out])
        out = np.empty((3, len(pending)), np.uint32)
        out[:, idx] = got
    else:
        out = sketch_reads_flat(codes_dev, pending, k)
    khi, klo, meta = out
    pos = (meta >> 1).astype(np.int32)
    strand = (meta & 1).astype(np.int8)
    key = (khi.astype(np.uint64) << np.uint64(32)) | klo.astype(np.uint64)
    mpos = np.where(strand == 1, L - pos + k - 2, pos).astype(np.int32)
    return key, mpos, strand


def cluster_rounds(codes_dev, pool: np.ndarray, cfg: ResolvedConfig):
    """Run the k-decreasing clustering rounds over the device read store
    (an [N, L] tensor, or a ShardedReadStore with its slice on the device).

    Returns (ClusterSet, sg) where sg is the singleton rid list in the
    deterministic order singles are produced (replaces the mutex-appended
    reads->sg, kthread_bucket.c:406-430).
    """
    L = codes_dev.shape[1]
    K = cfg.k
    results: list[ClusterSet] = [ClusterSet.empty(L)]
    sg_parts: list[np.ndarray] = [np.zeros(0, np.int64)]

    pending = np.asarray(pool, np.int64)
    pre_cluster_reads = 0
    cluster_reads_total = 0
    last = 0
    rnd = 0
    k_round = K
    while len(pending) and k_round >= 4:
        rnd += 1
        if K - rnd <= 9:
            last += 1
        if rnd == cfg.max_rounds - 1:
            last += 1
        is_last = last > 0
        k_next = K - rnd  # ejected reads re-sketch with this k

        h, mpos, strand = _sketch(pending, codes_dev, k_round, L)
        cs, singles, ejected, nreads = _one_round(
            codes_dev, pending, h, mpos, strand, cfg.diff_threshold, L)
        results.append(cs)
        sg_parts.append(singles)
        cluster_reads_total += nreads

        if is_last:
            sg_parts.append(ejected)
            pending = np.zeros(0, np.int64)
        else:
            pending = ejected
        k_round = k_next

        if last:
            last += 1
        if cluster_reads_total - pre_cluster_reads < 100:
            last += 1
        pre_cluster_reads = cluster_reads_total
        if last > 1:
            if len(pending):
                sg_parts.append(pending)
            break
    else:
        if len(pending):
            sg_parts.append(pending)

    return ClusterSet.concat(results), np.concatenate(sg_parts)


def _sharded_lexsort(h, mpos, rids):
    """np.lexsort((rids, -mpos, h)), the sort itself split by hash-VALUE
    range across processes: equal keys never straddle ranks, so the
    rank-order concatenation of the per-range lexsorts is the global one.
    Splitters come from a deterministic sample, identical on every rank."""
    pid, nproc = dist.process_grid()
    neg = -mpos.astype(np.int64)
    if nproc == 1:
        return np.lexsort((rids, neg, h))
    sample = np.sort(h[::max(1, len(h) // 65536)])
    cuts = (sample[(len(sample) * np.arange(1, nproc)) // nproc]
            if len(sample) else np.zeros(0, h.dtype))
    mask = np.ones(len(h), bool)
    if pid and len(cuts):
        mask &= h >= cuts[pid - 1]
    if pid < nproc - 1 and len(cuts):
        mask &= h < cuts[pid]
    idx = np.flatnonzero(mask)
    return dist.allgather_ragged(idx[np.lexsort((rids[idx], neg[idx],
                                                 h[idx]))])


def _one_round(codes_dev, rids, h, mpos, strand, e, L):
    """One bucket round: sort -> segments -> consensus -> ejection.

    Returns (ClusterSet, singles, ejected, n_clustered_reads).
    """
    order = _sharded_lexsort(h, mpos, rids)
    h, mpos, strand, rids = h[order], mpos[order], strand[order], rids[order]
    new_seg = np.ones(len(h), bool)
    new_seg[1:] = h[1:] != h[:-1]
    seg_id = np.cumsum(new_seg) - 1
    seg_start = np.flatnonzero(new_seg)
    seg_sizes = np.diff(np.append(seg_start, len(h)))

    multi = seg_sizes >= 2
    singles = rids[np.isin(seg_id, np.flatnonzero(~multi))]
    keep = multi[seg_id]
    if not keep.any():
        return ClusterSet.empty(L), np.sort(singles), np.zeros(0, np.int64), 0

    h2, mpos2, strand2, rids2 = h[keep], mpos[keep], strand[keep], rids[keep]
    seg2 = (np.cumsum(np.r_[True, h2[1:] != h2[:-1]]) - 1).astype(np.int64)
    n2 = int(seg2[-1]) + 1

    # alignment offsets: first (max) mpos of each segment anchors column 0
    first_idx = np.r_[0, 1 + np.flatnonzero(seg2[1:] != seg2[:-1])]
    off = (mpos2[first_idx][seg2] - mpos2).astype(np.int32)

    _ref, _rptr, diffs = consensus_from_members(
        L, seg2, off, rids2, strand2, n2, codes_dev, want_ref=False)

    surv = diffs <= e
    ejected = rids2[~surv]

    # survivor recount; clusters keep >= 2 members
    surv_per = np.bincount(seg2[surv], minlength=n2)
    good = surv_per >= 2
    lonely = surv & ~good[seg2]          # single survivor -> back to pool
    ejected = np.concatenate([ejected, rids2[lonely]])
    final = surv & good[seg2]
    if not final.any():
        return ClusterSet.empty(L), np.sort(singles), np.sort(ejected), 0

    segF = seg2[final]
    remap = np.cumsum(good) - 1
    segF = remap[segF]
    nF = int(segF[-1]) + 1
    offF = off[final]
    # rebase offsets so each cluster starts at column 0 (reference trims
    # leading zero-coverage columns, kthread_bucket.c:304-350)
    min_off = np.full(nF, np.iinfo(np.int32).max, np.int64)
    np.minimum.at(min_off, segF, offF)
    offF = (offF - min_off[segF]).astype(np.int32)

    refF, rptrF, _ = consensus_from_members(
        L, segF, offF, rids2[final], strand2[final], nF, codes_dev,
        want_diffs=False)
    cptr = np.zeros(nF + 1, np.int64)
    np.cumsum(np.bincount(segF, minlength=nF), out=cptr[1:])
    cs = ClusterSet(L, rids2[final], offF, strand2[final], cptr, refF, rptrF)
    return cs, np.sort(singles), np.sort(ejected), int(final.sum())
