"""Contig merge rounds (reference: combine_cluster, kthread_cb.c:570-661).

Each generation sketches the contigs with windowed (w,k)-minimizers, indexes
the first m of each contig, probes every contig's minimizers against the
index, verifies candidates with ``match_pro`` (mismatches over the full
two-sided overlap, kthread_cb.c:36-52) and merges by a deterministic maximal
matching. Generations continue until the contig count changes by < 100
(kthread_cb.c:621-625).

1. windowed sketch of all contigs on the device (``ops.sketch``), in
   length-bucketed chunks of a fixed plan,
2. candidate pairs from the native index probe (``native.probe_index_pairs``),
3. overlap scoring in native code (``native.score_overlaps``),
4. conflict-free greedy matching over the (score, a, b, d)-sorted candidates,
5. merged consensus by re-voting all members on the device (construct_ref2,
   kthread_cb.c:105-218) or, with ``merge_revote`` off, by splicing.

In a multi-process run each rank sketches a range of the plan's chunks,
probes a range of the probes and scores a range of the pairs; the results
all-gather in rank order, so every rank holds the single-process arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from minicom_tpu_torch import native
from minicom_tpu_torch.config import ResolvedConfig
from minicom_tpu_torch.ops import cuda
from minicom_tpu_torch.ops.sketch import sketch_windowed_flat
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.pipeline.cluster import (ClusterSet,
                                                consensus_from_members)
from minicom_tpu_torch.stats import substage as _sub

_LMAX_FLOOR = 128      # smallest contig-length bucket
_ROWS_TILE_CAP = 2048  # contig rows per sketch launch
_SKETCH_BUDGET = 1 << 26  # bases per padded sketch chunk


# The sketch plan shapes the archive: its chunk order is the order of the
# flat minimizer list (which feeds the stable index sort and the capped
# probe walk), and each chunk's slot count mb decides which minimizers are
# kept. It is the JAX package's plan, unchanged.

def _batch_m(Lmax: int, k: int, w: int, cap: int) -> int:
    """Probe slots per contig for an Lmax bucket: expected emission density
    is ~2S/(w+1) (+ties); ``cap`` is cfg.merge_rank_cap."""
    S = max(Lmax - k + 1, 1)
    m = min(cap, max(8, int(2.2 * S / (w + 1)) + 8))
    return min(cap, (m + 7) & ~7)


def _lmax_bucket(n: int) -> int:
    """Contig lengths quantize to a pow4 ladder (128, 512, 2048, ...)."""
    Lmax = _LMAX_FLOOR
    while Lmax < n:
        Lmax *= 4
    return Lmax


def _rows_tile(Lmax: int) -> int:
    """Row count per sketch chunk for a ladder rung."""
    return int(min(_ROWS_TILE_CAP, max(256, _SKETCH_BUDGET // Lmax)))


def _select(cs: ClusterSet, idx: np.ndarray) -> ClusterSet:
    """Subset of clusters (by index array) as a new ClusterSet."""
    sizes = cs.cluster_sizes()[idx]
    rlens = cs.ref_lengths()[idx]
    cptr = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(sizes, out=cptr[1:])
    rptr = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(rlens, out=rptr[1:])
    mem_idx = (np.repeat(cs.cluster_ptr[idx] - cptr[:-1], sizes)
               + np.arange(int(cptr[-1])))
    ref_idx = (np.repeat(cs.ref_ptr[idx] - rptr[:-1], rlens)
               + np.arange(int(rptr[-1])))
    return ClusterSet(cs.readlen, cs.mem_rid[mem_idx], cs.mem_off[mem_idx],
                      cs.mem_dir[mem_idx], cptr, cs.ref_flat[ref_idx], rptr)


def sketch_contigs(cs: ClusterSet, k: int, w: int, rank_cap: int,
                   device: torch.device, stats: dict | None = None):
    """Windowed minimizers of every contig, length-bucketed chunks.

    The flat contig stream goes to the device once, then (start, length,
    mb) of this rank's rows; one launch sketches them all, the kernel
    reading the bases in place, and the kept entries come back compacted.

    Returns flat arrays (key32, contig_id, pos, strand, rank) over all valid
    entries, up to mb per contig in position order; ``rank`` is the entry's
    position-ordinal within its contig (the index holds ranks < m, every
    entry probes, kthread_bucket.c:451-475, kthread_cb.c:267-274).
    """
    lens = cs.ref_lengths()
    C = cs.n_clusters
    if C == 0 or len(cs.ref_flat) == 0:
        z = np.zeros(0, np.int64)
        return (np.zeros(0, np.uint32), z, z.astype(np.int32),
                z.astype(np.int8), z.astype(np.int32))
    order = np.argsort(lens, kind="stable")
    plan = []
    i = 0
    while i < C:
        Lmax = _lmax_bucket(max(int(lens[order[i]]), k + 1))
        tile = _rows_tile(Lmax)
        j = i
        while j < C and j - i < tile and lens[order[j]] <= Lmax:
            j += 1
        plan.append((i, j, Lmax, tile))
        i = j
    # each rank sketches a contiguous chunk range, weighted by padded size,
    # in one launch: the range's rows in plan order, each with its rung's mb
    b0, b1 = dist.my_partition(np.array([p[3] * p[2] for p in plan]))
    mine = plan[b0:b1]
    rows = order[mine[0][0]:mine[-1][1]] if mine else order[:0]
    mb = np.repeat([_batch_m(Lmax, k, w, rank_cap) for _, _, Lmax, _ in mine],
                   [j - i for i, j, _, _ in mine]).astype(np.int64)
    key, meta, nv = sketch_windowed_flat(
        cuda.to_device(cs.ref_flat, device), cs.ref_ptr[rows], lens[rows], mb, k,
        w)
    # rows whose slot budget saturated (true emission count unknown past
    # mb) — the drop signal for the rank cap
    saturated = int((nv >= mb).sum())
    first = np.cumsum(nv) - nv
    local = [key, np.repeat(rows, nv), (meta >> 1).astype(np.int32),
             (meta & 1).astype(np.int8),
             (np.arange(len(key)) - np.repeat(first, nv)).astype(np.int32)]
    *flat, sat = dist.allgather_ragged_many(
        local + [np.array([saturated], np.int64)])
    if stats is not None:   # summed over the ranks: the single-process count
        stats["merge_rank_saturated"] = (
            stats.get("merge_rank_saturated", 0) + int(sat.sum()))
    return tuple(flat)


def _candidate_pairs(key, cid, pos, strand, rank, m, stats, new_from,
                     probe_cap):
    """Ordered pairs (a, b, shift) of contigs sharing a minimizer with equal
    strand; shift d aligns b into a's coordinates.

    The INDEX holds each contig's first ``m`` minimizers
    (kthread_bucket.c:451-475) while every minimizer probes it; hits per
    probe are capped at ``probe_cap`` and drops counted in ``stats``.
    ``new_from``: only pairs touching a contig id >= new_from can be new
    (incremental generations): new-contig probes against the full index,
    old-contig probes against the new contigs' index entries."""
    idx = rank < m

    def _probe(pmask, imask):
        if not imask.any() or not pmask.any():
            return (np.zeros(0, np.int64),) * 3
        # each rank probes a contiguous range of the probes against the
        # whole (replicated) index; pairs and drops gather in rank order
        pi = np.flatnonzero(pmask)
        r0, r1 = dist.my_partition(np.ones(len(pi), np.int32))
        pi = pi[r0:r1]
        a, b, d, dropped = native.probe_index_pairs(
            key[imask], cid[imask], pos[imask], strand[imask],
            key[pi], cid[pi], pos[pi], strand[pi], probe_cap)
        a, b, d, dropped = dist.allgather_ragged_many(
            [a, b, d, np.array([dropped], np.int64)])
        if stats is not None:
            stats["merge_probe_drops"] = (
                stats.get("merge_probe_drops", 0) + int(dropped.sum()))
        return a, b, d

    if new_from is None:
        parts = [_probe(np.ones(len(key), bool), idx)]
    else:
        newp = cid >= new_from
        parts = [_probe(newp, idx), _probe(~newp, idx & newp)]
    a, b, d = (np.concatenate([p[i] for p in parts]) for i in range(3))
    if len(a) == 0:
        return (np.zeros(0, np.int64),) * 3
    # unique (a, b, d) triples: one lexsort + adjacent-equal mask
    order = np.lexsort((d, b, a))
    a, b, d = a[order], b[order], d[order]
    keep = np.ones(len(a), bool)
    keep[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1]) | (d[1:] != d[:-1])
    return a[keep], b[keep], d[keep]


def _score_pairs(cs: ClusterSet, a, b, d, cap: int) -> np.ndarray:
    """match_pro mismatch scores of the pairs (``native.score_overlaps``);
    each rank scores a contiguous pair range weighted by overlap length,
    and the scores gather in rank order."""
    lens = cs.ref_lengths()
    r0, r1 = dist.my_partition(np.minimum(lens[a], lens[b]))
    return dist.allgather_ragged(native.score_overlaps(
        cs.ref_flat, cs.ref_ptr, a[r0:r1], b[r0:r1], d[r0:r1], cap))


def merge_contigs(cset: ClusterSet, cfg: ResolvedConfig,
                  device: torch.device, stats: dict | None = None,
                  incremental: bool = True, codes_dev=None) -> ClusterSet:
    """Merge generations over ``cset``; the contig sketches run on
    ``device``. With ``codes_dev`` (the device read store: a tensor, or a
    ShardedReadStore with its slice on the device) and cfg.merge_revote,
    each merged contig is re-voted over all its members; otherwise the two
    consensus strings are spliced.

    ``incremental=False`` re-sketches every contig and re-searches the full
    candidate space each generation (the reference's behavior,
    kthread_cb.c:580) — the oracle of the incremental search."""
    revote = cfg.merge_revote and codes_dev is not None
    pre_tot = 0
    sk = None  # cached (key, cid, pos, strand, rank) of contig minimizers
    new_from = None  # incremental probing: only pairs touching ids >= this
    while cset.n_clusters > 1:
        if sk is None:
            with _sub(stats, "merge_sketch"):
                sk = sketch_contigs(cset, cfg.k, cfg.contig_window,
                                    cfg.merge_rank_cap, device, stats)
        # After the first generation only pairs touching a freshly merged
        # contig can exist: the matching below is maximal, so any scored-OK
        # pair between two surviving contigs would have been merged, and
        # score-rejected pairs stay rejected because neither contig changed.
        with _sub(stats, "merge_candidates"):
            a, b, d = _candidate_pairs(*sk, cfg.first_minimizers, stats,
                                       new_from, cfg.merge_probe_cap)
        n_merges = 0
        if len(a):
            with _sub(stats, "merge_score"):
                scores = _score_pairs(cset, a, b, d, cfg.cb_threshold)
            ok = scores <= cfg.cb_threshold
            a, b, d, scores = a[ok], b[ok], d[ok], scores[ok]
            # deterministic matching, best score first: each pass takes
            # every candidate that is the earliest remaining entry for BOTH
            # its endpoints
            with _sub(stats, "merge_match"):
                order = np.lexsort((d, b, a, scores))
                a_s, b_s, d_s = a[order], b[order], d[order]
                matched = np.zeros(cset.n_clusters, bool)
                pa, pb, pd = [], [], []
                live = np.arange(len(a_s))
                while len(live):
                    aa, bb = a_s[live], b_s[live]
                    ok = ~matched[aa] & ~matched[bb]
                    live = live[ok]
                    if not len(live):
                        break
                    aa, bb = a_s[live], b_s[live]
                    idxs = np.arange(len(live))
                    node_first = np.full(cset.n_clusters, len(live), np.int64)
                    np.minimum.at(node_first, aa, idxs)
                    np.minimum.at(node_first, bb, idxs)
                    take = (node_first[aa] == idxs) & (node_first[bb] == idxs)
                    if not take.any():
                        break
                    sel = live[take]
                    pa.append(a_s[sel]); pb.append(b_s[sel]); pd.append(d_s[sel])
                    matched[a_s[sel]] = matched[b_s[sel]] = True
                    live = live[~take]
                n_merges = sum(len(x) for x in pa)
            if n_merges:
                with _sub(stats, "merge_apply"):
                    cset, kept_old, n_pairs = _apply_merges(
                        cset, np.concatenate(pa), np.concatenate(pb),
                        np.concatenate(pd), codes_dev if revote else None)
                # untouched contigs keep their cached minimizers (per-contig
                # sketches are batch-independent); only the merged contigs,
                # appended after the survivors, are sketched fresh
                n_keep = len(kept_old)
                remap = np.full(len(matched), -1, np.int64)
                remap[kept_old] = np.arange(n_keep)
                key, cid, pos, strand, rank = sk
                live = remap[cid] >= 0
                merged_ids = np.arange(n_keep, n_keep + n_pairs)
                with _sub(stats, "merge_sketch"):
                    fk, fc, fp, fs, fr = sketch_contigs(
                        _select(cset, merged_ids), cfg.k, cfg.contig_window,
                        cfg.merge_rank_cap, device, stats)
                sk = (np.concatenate([key[live], fk]),
                      np.concatenate([remap[cid[live]], fc + n_keep]),
                      np.concatenate([pos[live], fp]),
                      np.concatenate([strand[live], fs]),
                      np.concatenate([rank[live], fr]))
                new_from = n_keep
        if not incremental:
            sk, new_from = None, None
        tot = cset.n_clusters
        if abs(pre_tot - tot) < 100 or n_merges == 0:
            break
        pre_tot = tot
    return cset


def _paste(dst, dst_starts, src, src_starts, seg_lens):
    """dst[dst_starts[i] + j] = src[src_starts[i] + j] for j < seg_lens[i]."""
    tot = int(seg_lens.sum())
    if tot == 0:
        return
    rep = np.repeat(np.arange(len(seg_lens)), seg_lens)
    off = np.arange(tot) - np.repeat(
        np.cumsum(np.r_[0, seg_lens[:-1]]), seg_lens)
    dst[dst_starts[rep] + off] = src[src_starts[rep] + off]


def _apply_merges(cs: ClusterSet, a, b, d, codes_dev=None):
    """Merge pairs (a <- b shifted by d).

    With ``codes_dev``: the merged consensus is re-voted over ALL members
    (construct_ref2, kthread_cb.c:105-218): span [0, max(off)+readlen),
    majority vote, no ejection. Without it: the consensus is the SPLICE of
    the two existing consensus strings, each overlap column keeping the base
    of the side with more members covering it.

    Returns (new ClusterSet = [untouched contigs..., merged pairs...],
    indices of the untouched contigs in the OLD numbering, n_pairs)."""
    L = cs.readlen
    touched = np.zeros(cs.n_clusters, bool)
    touched[a] = touched[b] = True
    kept_old = np.flatnonzero(~touched)
    keep = _select(cs, kept_old)

    sizes = cs.cluster_sizes()
    # B offsets shift by d when d >= 0; A shifts by -d when d < 0
    shift_a = np.where(d < 0, -d, 0)
    shift_b = np.where(d >= 0, d, 0)
    na, nb = sizes[a], sizes[b]
    pair_sizes = na + nb
    P = len(a)
    cptr = np.zeros(P + 1, np.int64)
    np.cumsum(pair_sizes, out=cptr[1:])
    M = int(cptr[-1])
    # member gather: first A's members then B's per pair
    local = np.arange(M) - np.repeat(cptr[:-1], pair_sizes)
    from_a = local < np.repeat(na, pair_sizes)
    src = np.where(from_a,
                   np.repeat(cs.cluster_ptr[a], pair_sizes) + local,
                   np.repeat(cs.cluster_ptr[b], pair_sizes) + local
                   - np.repeat(na, pair_sizes))
    mem_rid = cs.mem_rid[src]
    mem_dir = cs.mem_dir[src]
    mem_off = (cs.mem_off[src].astype(np.int64)
               + np.where(from_a, np.repeat(shift_a, pair_sizes),
                          np.repeat(shift_b, pair_sizes)))

    lens = cs.ref_lengths()
    la, lb = lens[a], lens[b]
    span = np.maximum(shift_a + la, shift_b + lb)
    ref_ptr = np.zeros(P + 1, np.int64)
    np.cumsum(span, out=ref_ptr[1:])
    total = int(ref_ptr[-1])

    if codes_dev is not None:
        # every contig length is max(member off) + L by construction, so the
        # re-vote spans equal the splice spans
        seg = np.repeat(np.arange(P, dtype=np.int64), pair_sizes)
        ref_flat, rptr2, _ = consensus_from_members(
            L, seg, mem_off, mem_rid, mem_dir, P, codes_dev,
            want_diffs=False)
        if rptr2[-1] != total:
            raise RuntimeError("re-vote span differs from the member extent")
        merged = ClusterSet(L, mem_rid, mem_off.astype(np.int32), mem_dir,
                            cptr, ref_flat, rptr2)
        return ClusterSet.concat([keep, merged]), kept_old, P

    ref_flat = np.zeros(total, np.uint8)
    _paste(ref_flat, ref_ptr[:-1] + shift_b, cs.ref_flat, cs.ref_ptr[b], lb)
    _paste(ref_flat, ref_ptr[:-1] + shift_a, cs.ref_flat, cs.ref_ptr[a], la)
    # per-column coverage vote in the overlap: cov = (#A members) - (#B
    # members) covering each merged column, via span-endpoint deltas + one
    # cumsum; columns where B's coverage wins take B's base back
    seg = np.repeat(np.arange(P), pair_sizes)
    mstart = ref_ptr[seg] + mem_off
    sign = np.where(from_a, np.int32(1), np.int32(-1))
    cov = np.zeros(total + 1, np.int32)
    np.add.at(cov, mstart, sign)
    np.add.at(cov, mstart + L, -sign)
    cov = np.cumsum(cov[:-1], dtype=np.int64)
    ostart = np.maximum(shift_a, shift_b)
    olen = np.maximum(np.minimum(shift_a + la, shift_b + lb) - ostart, 0)
    orep = np.repeat(np.arange(P), olen)
    ooff = np.arange(int(olen.sum())) - np.repeat(
        np.cumsum(np.r_[0, olen[:-1]]), olen)
    ocol = ref_ptr[orep] + ostart[orep] + ooff
    mask = cov[ocol] < 0
    bwin, prow = ocol[mask], orep[mask]
    ref_flat[bwin] = cs.ref_flat[cs.ref_ptr[b[prow]]
                                 + (bwin - ref_ptr[prow] - shift_b[prow])]

    merged = ClusterSet(L, mem_rid, mem_off.astype(np.int32), mem_dir,
                        cptr, ref_flat, ref_ptr)
    return ClusterSet.concat([keep, merged]), kept_old, P
