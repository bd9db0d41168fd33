"""Singleton realignment ladder (reference: kthread_hash_realign.c +
bbhashdict.c).

Leftover singletons are placed onto contig windows: the reference's BooPHF
substring dictionaries become sorted-key tables, every (contig, offset)
window probes every dictionary forward and reverse-complement, a candidate
passes by 2-bit XOR popcount <= threshold plus the encode-cost <= 0.4*L
rule (on the rc path only above threshold 24, kthread_hash_realign.c:461),
and every read takes its best candidate under the order (popcount, contig,
offset, dir). The threshold ladder e, e+S, ... <= E with the "< 1000 new
reads" stop mirrors preprocess.c:197-232; each rung first absorbs
near-allA / near-allT singles into the AA/TT streams (bbhashdict.c:127-227).

The probe runs in host C++ (``native.realign_probe``); ``probe_numpy`` is
the vectorized numpy statement of the same search, kept as its oracle. In a
multi-process run every rank holds the singleton rows, probes a range of
the contigs, and the winners all-gather before the claim.
"""

from __future__ import annotations

import numpy as np

from minicom_tpu_torch import native
from minicom_tpu_torch.config import ResolvedConfig
from minicom_tpu_torch.ops.pack import (codes_to_ascii, pack_2bit_words,
                                        popcount_u32, revcomp_codes)
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.parallel.store import rows_all
from minicom_tpu_torch.pipeline.cluster import ClusterSet
from minicom_tpu_torch.stats import substage as _sub


def _pack_key(codes: np.ndarray, start: int, seg_len: int) -> np.ndarray:
    """[N, L] codes -> uint64 keys of the [start, start+seg_len) window."""
    w = codes[:, start:start + seg_len].astype(np.uint64)
    key = np.zeros(len(codes), np.uint64)
    for i in range(seg_len):
        key |= w[:, i] << np.uint64(2 * i)
    return key


class SortedKeyDict:
    """Sorted-key gather table replacing BooPHF+CSR (bbhashdict.h:21-43):
    lookup = binary search into the sorted keys; hits slice a range of
    singleton indices."""

    def __init__(self, keys: np.ndarray):
        self.order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[self.order]

    def lookup(self, queries: np.ndarray, max_hits: int):
        """(starts, counts) into self.order per query, count capped."""
        lo = np.searchsorted(self.sorted_keys, queries, side="left")
        hi = np.searchsorted(self.sorted_keys, queries, side="right")
        return lo, np.minimum(hi - lo, max_hits)


def realign_ladder(cset: ClusterSet, sg: np.ndarray, codes_sub: np.ndarray,
                   n_mask, cfg: ResolvedConfig, stats: dict | None = None):
    """Returns (cset', sg_leftover, absorbed_nearA, absorbed_nearT)."""
    L = cset.readlen
    extra_a: list[np.ndarray] = [np.zeros(0, np.int64)]
    extra_t: list[np.ndarray] = [np.zeros(0, np.int64)]
    if cset.n_clusters == 0 or len(sg) == 0:
        return cset, sg, extra_a[0], extra_t[0]

    ranges = cfg.dict_ranges()
    new_members = []            # (rid, cluster, off, dir) tuples as arrays
    pre_claimed_total = 0
    claimed_total = 0
    big_input = len(sg) > 1_000_000 and L >= 68

    # the singleton rows, fetched once (a collective on a sharded store) and
    # kept in step with sg as rungs absorb and claim reads
    sgc = rows_all(codes_sub, sg)
    thr = cfg.diff_threshold
    pop_a = pop_t = None    # per-read base-diff counts vs all-A / all-T:
    prev_thr = -1           # rung-invariant — computed once, subset as sg
    while thr <= cfg.max_threshold and len(sg):
        # --- near-allA/allT absorption at this threshold ------------------
        with _sub(stats, "realign_absorb"):
            if pop_a is None:
                pop_a, pop_t = native.popcounts_at(
                    sgc, np.arange(len(sg), dtype=np.int64))
            cand_a = pop_a <= thr
            cand_t = ~cand_a & (pop_t <= thr)
            # the encode-cost check is rung-invariant too, so only reads
            # whose popcount FIRST clears the threshold at this rung need it
            new_a = cand_a & (pop_a > prev_thr)
            new_t = cand_t & (pop_t > prev_thr)
            absorbed = np.zeros(len(sg), bool)
            for mask, const, bucket in ((new_a, b"A", extra_a),
                                        (new_t, b"T", extra_t)):
                rows = np.flatnonzero(mask)
                if len(rows) == 0:
                    continue
                restored = sgc[rows]
                restored[n_mask[sg[rows]]] = 4
                lens = native.diff_encode_lengths(
                    np.full((len(rows), L), const[0], np.uint8),
                    codes_to_ascii(restored), 1)
                take = rows[lens <= 0.4 * L]
                if len(take):
                    bucket.append(sg[take])
                    absorbed[take] = True
            prev_thr = thr
            if absorbed.any():
                keep = ~absorbed
                sg, pop_a, pop_t = sg[keep], pop_a[keep], pop_t[keep]
                sgc = sgc[keep]
        if len(sg) == 0:
            break

        # --- probe every (contig, offset) window fwd + rc -----------------
        with _sub(stats, "realign_probe"):
            cand_sg, cand_cl, cand_off, cand_dir, cand_pop = (
                x.astype(np.int64) if x.dtype != np.int8 else x
                for x in _probe(cset, sgc, ranges, cfg, thr))

        # --- best candidate per read (deterministic claim) ----------------
        if len(cand_sg):
            with _sub(stats, "realign_claim"):
                order = np.lexsort((cand_dir, cand_off, cand_cl, cand_pop,
                                    cand_sg))
                first = np.ones(len(order), bool)
                ss = cand_sg[order]
                first[1:] = ss[1:] != ss[:-1]
                pick = order[first]
                new_members.append((sg[cand_sg[pick]], cand_cl[pick],
                                   cand_off[pick], cand_dir[pick]))
                claimed = np.zeros(len(sg), bool)
                claimed[cand_sg[pick]] = True
                claimed_total += int(claimed.sum())
                keep = ~claimed
                sg, pop_a, pop_t = sg[keep], pop_a[keep], pop_t[keep]
                sgc = sgc[keep]

        # stopping rule (preprocess.c:219-228)
        max_new = 10_000 if big_input else 1_000
        if claimed_total - pre_claimed_total < max_new:
            break
        pre_claimed_total = claimed_total
        thr += cfg.thr_step

    if new_members:
        cset = _append_members(cset, new_members)
    ea = np.concatenate(extra_a) if len(extra_a) > 1 else extra_a[0]
    et = np.concatenate(extra_t) if len(extra_t) > 1 else extra_t[0]
    return cset, sg, ea, et


def _probe(cset: ClusterSet, sgc: np.ndarray, ranges, cfg: ResolvedConfig,
           thr: int):
    """``native.realign_probe`` winners over this rank's contiguous contig
    range (weighted by window count), all-gathered in rank order. Each
    rank's winners are the best per read within its range, so the claim
    lexsort over the gathered rows picks the global winner."""
    L = cset.readlen
    c0, c1 = dist.my_partition(np.maximum(cset.ref_lengths() - L + 1, 0))
    lo, hi = cset.ref_ptr[c0], cset.ref_ptr[c1]
    cand_sg, cand_cl, cand_off, cand_dir, cand_pop = native.realign_probe(
        cset.ref_flat[lo:hi], cset.ref_ptr[c0:c1 + 1] - lo, sgc,
        np.array([s for s, _ in ranges], np.int32), cfg.dict_seg_len, thr,
        cfg.max_search, rc_skip_cost=thr <= 24)
    return dist.allgather_ragged_many(
        [cand_sg, cand_cl + np.int32(c0), cand_off, cand_dir, cand_pop])


def probe_numpy(cset: ClusterSet, sgc: np.ndarray, cfg: ResolvedConfig,
                thr: int):
    """Every verified, encode-cost-checked candidate placement
    (sg_idx, contig, offset, dir, popcount) of the singleton rows ``sgc``
    at threshold ``thr``: the search ``native.realign_probe`` runs, before
    its reduction to the best placement per read."""
    L = cset.readlen
    ranges = cfg.dict_ranges()
    sg_words = pack_2bit_words(sgc)
    dicts = [SortedKeyDict(_pack_key(sgc, s, e - s + 1)) for (s, e) in ranges]
    n_off = np.maximum(cset.ref_lengths() - L + 1, 0)
    tot_w = int(n_off.sum())
    wseg = np.repeat(np.arange(cset.n_clusters), n_off)
    woff = (np.arange(tot_w)
            - np.repeat(np.cumsum(np.r_[0, n_off[:-1]]), n_off))
    wflat = cset.ref_ptr[wseg] + woff
    cand = _probe_and_verify(cset, wflat, wseg, woff, dicts, ranges,
                             sg_words, L, thr, cfg.max_search)
    if len(cand[0]) == 0:
        return cand
    ok = _encode_cost_ok(cset, sgc, *cand[:4], thr, L)
    return tuple(x[ok] for x in cand)


def _probe_and_verify(cset, wflat, wseg, woff, dicts, ranges, sg_words,
                      L, thr, max_search):
    """All (window x dict x strand) probes -> verified candidate arrays."""
    out = [[], [], [], [], []]
    CH = 1 << 16
    for s0 in range(0, len(wflat), CH):
        s1 = min(s0 + CH, len(wflat))
        wf, ws, wo = wflat[s0:s1], wseg[s0:s1], woff[s0:s1]
        win_codes = cset.ref_flat[wf[:, None] + np.arange(L)[None, :]]
        win_words = pack_2bit_words(win_codes)
        rc_codes = revcomp_codes(win_codes)
        rc_words = pack_2bit_words(rc_codes)
        for dno, (ds, de) in enumerate(ranges):
            seg_len = de - ds + 1
            for strand, wcodes, wwords in ((0, win_codes, win_words),
                                           (1, rc_codes, rc_words)):
                keys = _pack_key(wcodes, ds, seg_len)
                lo, cnt = dicts[dno].lookup(keys, max_search)
                tot = int(cnt.sum())
                if tot == 0:
                    continue
                rows = np.repeat(np.arange(len(keys)), cnt)
                hit = (np.repeat(lo, cnt)
                       + (np.arange(tot)
                          - np.repeat(np.cumsum(np.r_[0, cnt[:-1]]), cnt)))
                sg_idx = dicts[dno].order[hit]
                pop = popcount_u32(wwords[rows] ^ sg_words[sg_idx]).sum(axis=1)
                ok = pop <= thr
                out[0].append(sg_idx[ok])
                out[1].append(ws[rows[ok]])
                out[2].append(wo[rows[ok]])
                out[3].append(np.full(int(ok.sum()), strand, np.int8))
                out[4].append(pop[ok].astype(np.int32))
    if not out[0]:
        z = np.zeros(0, np.int64)
        return z, z, z, z.astype(np.int8), z.astype(np.int32)
    res = [np.concatenate(x) for x in out]
    # dedupe (same read found at same placement through several dicts)
    key = np.stack([res[0], res[1], res[2], res[3].astype(np.int64)], axis=1)
    _, uniq = np.unique(key, axis=0, return_index=True)
    return tuple(r[uniq] for r in res)


def _encode_cost_ok(cset, sgc, cand_sg, cand_cl, cand_off, cand_dir, thr, L):
    """encode_byte rule: diff-string length <= 0.4*L. Forward placements are
    always checked; reverse placements only when threshold > 24
    (kthread_hash_realign.c:393,461)."""
    ok = np.ones(len(cand_sg), bool)
    rows = np.flatnonzero((cand_dir == 0) | (thr > 24))
    CH = 1 << 18
    for s in range(0, len(rows), CH):
        sel = rows[s:s + CH]
        win = (cset.ref_ptr[cand_cl[sel]] + cand_off[sel])[:, None] \
            + np.arange(L)[None, :]
        codes = sgc[cand_sg[sel]]
        oriented = np.where((cand_dir[sel] == 1)[:, None],
                            revcomp_codes(codes), codes)
        lens = native.diff_encode_lengths(codes_to_ascii(cset.ref_flat[win]),
                                          codes_to_ascii(oriented), 0)
        ok[sel] = lens <= 0.4 * L
    return ok


def _append_members(cs: ClusterSet, batches) -> ClusterSet:
    """Append claimed reads (rid, cluster, off, dir) to their clusters."""
    rid = np.concatenate([b[0] for b in batches])
    cl = np.concatenate([b[1] for b in batches])
    off = np.concatenate([b[2] for b in batches])
    dirs = np.concatenate([b[3] for b in batches])
    per_cl = np.bincount(cl, minlength=cs.n_clusters)
    old_sizes = cs.cluster_sizes()
    cptr = np.zeros(cs.n_clusters + 1, np.int64)
    np.cumsum(old_sizes + per_cl, out=cptr[1:])
    M = int(cptr[-1])
    mem_rid = np.empty(M, np.int64)
    mem_off = np.empty(M, np.int32)
    mem_dir = np.empty(M, np.int8)
    # old members first within each cluster, then the new ones
    old_dst = np.repeat(cptr[:-1] - cs.cluster_ptr[:-1], old_sizes) \
        + np.arange(cs.n_members)
    mem_rid[old_dst] = cs.mem_rid
    mem_off[old_dst] = cs.mem_off
    mem_dir[old_dst] = cs.mem_dir
    order = np.argsort(cl, kind="stable")
    rank = np.arange(len(cl)) - np.repeat(
        np.cumsum(np.r_[0, per_cl[:-1]]), per_cl)
    dst = (cptr[:-1] + old_sizes)[cl[order]] + rank
    mem_rid[dst] = rid[order]
    mem_off[dst] = off[order]
    mem_dir[dst] = dirs[order]
    return ClusterSet(cs.readlen, mem_rid, mem_off, mem_dir, cptr,
                      cs.ref_flat, cs.ref_ptr)
