"""Segmented majority-vote consensus with per-member mismatch counts.

Members of every cluster of a pass share one flat column space: member m is
the read ``rd[m] >> 1`` of the read store, reverse-complemented when
``rd[m] & 1``, with its first base at column ``col[m]``. The consensus of a
column is the argmax of its four base counts, ties to the lowest code (the
reference's strict-greater update); a member's diff is its mismatch count
against the consensus under it.

``consensus_vote_flat`` (the pipeline's entry: host arrays with the clusters'
member and column pointers) and ``consensus_vote`` (tensors, one cluster of
members in any order) launch the CUDA kernel of ``csrc/consensus.cu`` on a
CUDA read store and run the plain PyTorch version below on a CPU one.
"""

from __future__ import annotations

import numpy as np
import torch

from minicom_tpu_torch.ops import cuda

# The most columns a tile owns. A tile's counts take 16 bytes a column of
# shared memory, and a tile of a wide cluster also counts up to L - 1 <= 255
# columns past what it owns: 2048 + 256 columns are 39,168 bytes with the
# votes, so several blocks share an SM.
TILE = 2048
L_MAX = 256
TILE_FIELDS = 6   # w0, w1, r1, i0, i1, indirect: see csrc/consensus.cu


def _consensus_plain(codes, rd, col, span, want_diffs):
    L = codes.shape[1]
    rows = codes[rd >> 1].to(torch.int64)
    rc = torch.where(rows < 4, 3 - rows, rows).flip(1)
    oriented = torch.where((rd & 1).bool()[:, None], rc, rows)
    cols = col[:, None] + torch.arange(L, device=codes.device)
    ok = oriented < 4
    counts = torch.bincount((cols * 4 + oriented)[ok],
                            minlength=span * 4).view(span, 4)
    best = torch.zeros(span, dtype=torch.int64, device=codes.device)
    top = counts[:, 0]
    for b in (1, 2, 3):
        better = counts[:, b] > top
        best = torch.where(better, b, best)
        top = torch.where(better, counts[:, b], top)
    diffs = None
    if want_diffs:
        diffs = (best[cols] != oriented).sum(dim=1, dtype=torch.int32)
    return best.to(torch.uint8), diffs


def _plan(col, seg_ptr, col_ptr, L, tile=TILE):
    """The kernel's tiles for clusters with member ranges ``seg_ptr`` and
    column ranges ``col_ptr`` (members of cluster s lie in its columns).
    Returns (tiles [n, TILE_FIELDS] int64 in column order, idx int64: the
    members of clusters wider than ``tile``, sorted by column).

    Clusters at most tile / 2 wide pack into shared tiles: a run of them
    whose first columns fall in one tile / 2 bucket (so a tile spans fewer
    than ``tile`` columns). One up to ``tile`` wide has a tile to itself.
    A wider one is cut into pieces of ``tile`` columns; a piece's tile also
    counts the L - 1 columns past it, from the members (in idx) that reach
    any of its columns."""
    width = np.diff(col_ptr)
    lo, hi = col_ptr[:-1], col_ptr[1:]
    half = max(tile // 2, 1)
    narrow = width <= half
    wide = width > tile
    parts = []

    s = np.flatnonzero(narrow)
    if len(s):
        bucket = lo[s] // half
        new = np.r_[True, (np.diff(s) != 1) | (np.diff(bucket) != 0)]
        first = s[new]
        last = np.r_[s[np.flatnonzero(new)[1:] - 1], s[-1]]
        parts.append(np.stack([lo[first], hi[last], hi[last], seg_ptr[first],
                               seg_ptr[last + 1], np.zeros_like(first)], 1))
    s = np.flatnonzero(~narrow & ~wide)
    parts.append(np.stack([lo[s], hi[s], hi[s], seg_ptr[s], seg_ptr[s + 1],
                           np.zeros_like(s)], 1))

    s = np.flatnonzero(wide)
    idx = np.zeros(0, np.int64)
    if len(s):
        n = -(-width[s] // tile)
        ws = np.repeat(s, n)
        p_lo = lo[ws] + tile * (np.arange(n.sum()) - np.repeat(np.cumsum(n)
                                                               - n, n))
        p_hi = np.minimum(p_lo + tile, hi[ws])
        w1 = np.minimum(p_hi + L - 1, hi[ws])
        mine = np.repeat(wide, np.diff(seg_ptr))
        idx = np.flatnonzero(mine)
        # clusters own disjoint, increasing column ranges: sorted by column,
        # the members of each wide cluster lie together
        idx = idx[np.argsort(col[idx], kind="stable")]
        sc = col[idx]
        parts.append(np.stack([
            p_lo, w1, p_hi,
            np.searchsorted(sc, np.maximum(p_lo - L + 1, lo[ws])),
            np.searchsorted(sc, w1), np.ones_like(ws)], 1))

    tiles = np.concatenate(parts).astype(np.int64).reshape(-1, TILE_FIELDS)
    tiles = tiles[tiles[:, 1] > tiles[:, 0]]
    return tiles[np.argsort(tiles[:, 0], kind="stable")], idx


def _check(n_rows, L, rd, col, seg_ptr, col_ptr, span):
    """ValueError on malformed pointers, IndexError on a member outside the
    read store or its cluster's columns: host arrays, so no device sync."""
    M = len(rd)
    if rd.shape != col.shape or rd.ndim != 1:
        raise ValueError("rd and col differ in shape")
    if (seg_ptr.ndim != 1 or seg_ptr.shape != col_ptr.shape
            or len(seg_ptr) < 1):
        raise ValueError("seg_ptr and col_ptr: want two pointer arrays of "
                         "one length")
    if (seg_ptr[0] != 0 or seg_ptr[-1] != M or col_ptr[0] != 0
            or col_ptr[-1] != span or (np.diff(seg_ptr) < 0).any()
            or (np.diff(col_ptr) < 0).any()):
        raise ValueError("seg_ptr must run from 0 to M and col_ptr from 0 to "
                         "span, neither decreasing")
    if M:
        s = np.flatnonzero(np.diff(seg_ptr))   # clusters with members
        if (rd.min() < 0 or rd.max() >> 1 >= n_rows
                or (np.minimum.reduceat(col, seg_ptr[s]) < col_ptr[s]).any()
                or (np.maximum.reduceat(col, seg_ptr[s]) + L
                    > col_ptr[s + 1]).any()):
            raise IndexError("member outside the read store or its "
                             "cluster's columns")


def _upload(rd, col, seg_ptr, col_ptr, L, dev):
    """(rd, col) and the tile plan on ``dev`` in one copy from pinned
    memory: (the int64 buffer the kernel parses, its tile count, its widest
    tile)."""
    tiles, idx = _plan(col, seg_ptr, col_ptr, L)
    parts = (rd, col, tiles.ravel(), idx)
    n = sum(map(len, parts))
    host = (cuda.pinned(n, torch.int64, dev) if dev.type == "cuda"
            else torch.empty(n, dtype=torch.int64))
    np.concatenate(parts, out=host.numpy())
    cap = int((tiles[:, 1] - tiles[:, 0]).max()) if len(tiles) else 0
    return cuda.to_device(host, dev, non_blocking=True), len(tiles), cap


def _kernel(codes, plan, M, n_tiles, cap, ref=None, diffs=None):
    """One launch over an uploaded plan; writes the outputs given."""
    cuda.launch("mtc_consensus_vote", codes, codes.shape[1], plan, M,
                n_tiles, cap, (ref is not None) | 2 * (diffs is not None),
                diffs, ref)


def _launch(codes, rd, col, seg_ptr, col_ptr, span, want_ref, want_diffs):
    """One upload and one kernel launch. Returns the device output, diffs
    (int32, when asked) then ref bytes, and its views (ref, diffs)."""
    cuda.require_cuda(codes)
    L, M = codes.shape[1], len(rd)
    if L > L_MAX:
        raise ValueError(f"reads of {L} bases: the kernel takes at most "
                         f"{L_MAX}")
    nd = 4 * M if want_diffs else 0
    out = torch.empty(nd + (span if want_ref else 0), dtype=torch.uint8,
                      device=codes.device)
    ref, diffs = out[nd:], out[:nd].view(torch.int32)
    plan, n_tiles, cap = _upload(rd, col, seg_ptr, col_ptr, L, codes.device)
    if n_tiles:
        _kernel(codes, plan, M, n_tiles, cap, ref if want_ref else None,
                diffs if want_diffs else None)
    return out, ref, diffs


def consensus_vote_flat(codes: torch.Tensor, rd: np.ndarray, col: np.ndarray,
                        seg_ptr: np.ndarray, col_ptr: np.ndarray, span: int,
                        want_ref: bool = True, want_diffs: bool = True):
    """Consensus of ``span`` flat columns and the members' mismatch counts,
    cluster by cluster.

    codes: [N, L] uint8 read store (L <= 256 on the card); rd: [M] rid * 2 +
    dir; col: [M] start columns; seg_ptr, col_ptr: [C+1] the member range
    and the column range of each cluster, from 0 to M and from 0 to span,
    every member of a cluster within its columns (members of a cluster in
    any order). All but ``codes`` are host arrays, checked here. Returns
    host arrays (ref [span] uint8 or None, diffs [M] int32 or None) as
    asked. On the card: one upload (rd, col, the tile plan), one launch, one
    download of what was asked."""
    cuda.check(codes, torch.uint8, 2, "codes")
    rd, col, seg_ptr, col_ptr = (np.asarray(a, np.int64) for a in
                                 (rd, col, seg_ptr, col_ptr))
    _check(codes.shape[0], codes.shape[1], rd, col, seg_ptr, col_ptr, span)
    if codes.device.type == "cpu":
        ref, diffs = _consensus_plain(codes, torch.from_numpy(rd),
                                      torch.from_numpy(col), span, want_diffs)
        return (ref.numpy() if want_ref else None,
                diffs.numpy() if want_diffs else None)
    out, _, _ = _launch(codes, rd, col, seg_ptr, col_ptr, span, want_ref,
                        want_diffs)
    host = cuda.to_host(out).numpy()
    nd = 4 * len(rd) if want_diffs else 0
    return (host[nd:] if want_ref else None,
            host[:nd].view(np.int32) if want_diffs else None)


def consensus_vote(codes: torch.Tensor, rd: torch.Tensor, col: torch.Tensor,
                   span: int, want_ref: bool = True, want_diffs: bool = True):
    """Consensus of ``span`` flat columns and the members' mismatch counts,
    members in any order as one cluster.

    codes: [N, L] uint8 read store; rd: [M] int64 = rid * 2 + dir; col: [M]
    int64 start columns, each with col + L <= span. Returns (ref [span]
    uint8 or None, diffs [M] int32 or None), tensors on the store's device,
    as asked by ``want_ref`` / ``want_diffs``. Replaces
    ``consensus_fused_rid_u`` and the ``scatter_counts_rid_u`` /
    ``consensus_finalize`` / ``member_diffs_packed_rid_u`` chain. rd and col
    come to the host for the checks and the plan; the pipeline calls
    ``consensus_vote_flat``."""
    cuda.check(codes, torch.uint8, 2, "codes")
    cuda.check(rd, torch.int64, 1, "rd")
    cuda.check(col, torch.int64, 1, "col")
    if not (codes.device == rd.device == col.device):
        raise ValueError("codes, rd and col on different devices")
    if col.shape[0] != rd.shape[0]:
        raise ValueError("rd and col differ in length")
    h_rd, h_col = cuda.to_host(rd).numpy(), cuda.to_host(col).numpy()
    seg_ptr, col_ptr = np.array([0, len(h_rd)]), np.array([0, span])
    _check(codes.shape[0], codes.shape[1], h_rd, h_col, seg_ptr, col_ptr,
           span)
    if codes.device.type == "cpu":
        ref, diffs = _consensus_plain(codes, rd, col, span, want_diffs)
    else:
        _, ref, diffs = _launch(codes, h_rd, h_col, seg_ptr, col_ptr, span,
                                want_ref, want_diffs)
    return (ref if want_ref else None), (diffs if want_diffs else None)
