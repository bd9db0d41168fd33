"""Read classification & N-substitution (reference: kthread_reads.c:40-230).

Routes each read into one of the special classes or the clustering pool,
in the reference's rule order:

1. all bases A            -> allA
2. all bases T            -> allT
3. all bases N            -> allN
4. #(T,G,C,N) <= e        -> nearA  (AA stream)
5. #(A,G,C,N) <= e        -> nearT  (TT stream)
6. #(A,T,G,C) <= e        -> mostlyN (NN stream)
7. else if #N <= 0.4*L    -> substitute N with the majority base
                             (priority A,T,G,C on ties) and sketch/cluster
8. else                   -> nfile  (single_N stream)

Host numpy: masked counts over the [N, L] code matrix in row blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from minicom_tpu_torch.config import ResolvedConfig
from minicom_tpu_torch.parallel import distributed as dist
from minicom_tpu_torch.parallel.store import ShardedReadStore


class SparseNMask:
    """CSR store of N positions. Indexing with an int array materializes
    just those rows as a dense bool block, so call sites read like a dense
    mask while the resident cost is ~2 entries per read with an N."""

    def __init__(self, L: int, has_n: np.ndarray, nz_rids: np.ndarray,
                 ptr: np.ndarray, pos: np.ndarray):
        self.L = L
        self.has_n = has_n          # [N] bool
        self.nz_rids = nz_rids      # sorted rids that contain N
        self.ptr = ptr              # [len(nz_rids) + 1] int64
        self.pos = pos              # int32 N positions, CSR by nz_rids

    def __getitem__(self, rids) -> np.ndarray:
        rids = np.atleast_1d(np.asarray(rids, np.int64))
        out = np.zeros((len(rids), self.L), bool)
        sel = np.flatnonzero(self.has_n[rids])
        if len(sel) == 0:
            return out
        ri = np.searchsorted(self.nz_rids, rids[sel])
        cnt = self.ptr[ri + 1] - self.ptr[ri]
        rows_rep = np.repeat(sel, cnt)
        flat = (np.repeat(self.ptr[ri] - np.cumsum(np.r_[0, cnt[:-1]]), cnt)
                + np.arange(int(cnt.sum())))
        out[rows_rep, self.pos[flat]] = True
        return out


@dataclasses.dataclass
class Classified:
    codes_sub: np.ndarray     # [N, L] uint8 codes with N substituted (0..3),
    #                           or the ShardedReadStore holding them
    has_n: np.ndarray         # [N] bool — read contained at least one N
    n_mask: SparseNMask       # N positions (sparse; [rids] -> dense rows)
    all_a: np.ndarray         # rid arrays, in input order
    all_t: np.ndarray
    all_n: np.ndarray
    near_a: np.ndarray
    near_t: np.ndarray
    mostly_n: np.ndarray
    nfile: np.ndarray         # N-heavy singles (single_N stream)
    pool: np.ndarray          # rids entering the clustering pipeline


_CHUNK = 1 << 20   # reads per classify block (bounds transient count arrays)
_CLASSES = ("all_a", "all_t", "all_n", "near_a", "near_t", "mostly_n",
            "nfile", "pool")


def classify(codes, cfg: ResolvedConfig) -> Classified:
    """codes: [N, L] uint8 with N=4, or a ShardedReadStore. Substitutes IN
    PLACE: the caller's matrix becomes codes_sub, the pipeline's one
    resident read store.

    Sharded store: each rank classifies its OWN row slice, then the class
    lists, has_n flags and sparse N positions are all-gathered in rank
    order, which is ascending-rid order: the result is the unsharded one."""
    if isinstance(codes, ShardedReadStore):
        local = _classify_core(codes.local, cfg, codes.r0)
    else:
        local = _classify_core(codes, cfg, 0)
    *lists, has_n, rows, cols = dist.allgather_ragged_many(
        [local[k] for k in _CLASSES + ("has_n", "nz_rows", "nz_cols")])
    nz_rids = np.unique(rows)
    per = (np.searchsorted(rows, nz_rids, side="right")
           - np.searchsorted(rows, nz_rids, side="left"))
    ptr = np.zeros(len(nz_rids) + 1, np.int64)
    np.cumsum(per, out=ptr[1:])
    return Classified(codes_sub=codes, has_n=has_n,
                      n_mask=SparseNMask(codes.shape[1], has_n, nz_rids, ptr,
                                         cols),
                      **dict(zip(_CLASSES, lists)))


def _classify_core(codes: np.ndarray, cfg: ResolvedConfig, rid0: int) -> dict:
    """Class rid lists, has_n and N positions (rows as global rids) of the
    rows ``codes``, whose first is rid ``rid0``; substitutes N in place."""
    n, L = codes.shape
    e = cfg.diff_threshold
    masks = {k: np.zeros(n, bool) for k in _CLASSES}
    has_n = np.zeros(n, bool)
    npos_rows: list[np.ndarray] = [np.zeros(0, np.int64)]
    npos_cols: list[np.ndarray] = [np.zeros(0, np.int32)]

    for s in range(0, n, _CHUNK):
        t = min(s + _CHUNK, n)
        blk = codes[s:t]
        cnt = np.zeros((5, t - s), dtype=np.int32)
        for b in range(5):
            cnt[b] = (blk == b).sum(axis=1, dtype=np.int32)
        cA, cC, cG, cT, cN = cnt

        is_all_a = cA == L
        is_all_t = cT == L
        is_all_n = cN == L
        taken = is_all_a | is_all_t | is_all_n
        is_near_a = ~taken & (cT + cG + cC + cN <= e)
        taken |= is_near_a
        is_near_t = ~taken & (cA + cG + cC + cN <= e)
        taken |= is_near_t
        is_mostly_n = ~taken & (cA + cT + cG + cC <= e)
        taken |= is_mostly_n
        is_nfile = ~taken & (cN > 0.4 * L)
        for name, m in (("all_a", is_all_a), ("all_t", is_all_t),
                        ("all_n", is_all_n), ("near_a", is_near_a),
                        ("near_t", is_near_t), ("mostly_n", is_mostly_n),
                        ("nfile", is_nfile),
                        ("pool", ~taken & ~is_nfile)):
            masks[name][s:t] = m
        has_n[s:t] = cN > 0

        # sparse N positions + in-place majority substitution
        # (kthread_reads.c:182-205; tie priority A,T,G,C)
        r, c = np.nonzero(blk == 4)
        if len(r):
            npos_rows.append((r + s + rid0).astype(np.int64))
            npos_cols.append(c.astype(np.int32))
            maj_idx = np.argmax(np.stack([cA, cT, cG, cC]), axis=0)
            maj_code = np.array([0, 3, 2, 1], dtype=np.uint8)[maj_idx]
            blk[r, c] = maj_code[r]

    rid = np.arange(n, dtype=np.int64) + rid0
    return {**{k: rid[m] for k, m in masks.items()}, "has_n": has_n,
            "nz_rows": np.concatenate(npos_rows),
            "nz_cols": np.concatenate(npos_cols)}
