"""Minimizer sketches: the whole-read minimizer of the cluster rounds and the
windowed contig sketch of the merge stage.

Each wrapper launches its CUDA kernel (``csrc/sketch.cu``) on a CUDA tensor
and runs its plain PyTorch version on a CPU tensor; both compute the same
function, bit for bit, as the JAX package's device code and the host twins
in ``native/sketch.cpp``.

The plain versions carry u32 values in int64 (CPU PyTorch has no shifts or
compares on uint32) and mask every multiply of ``mix32`` to 32 bits: the
int64 product wraps, but its low 32 bits are right.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from minicom_tpu_torch.ops import cuda

U32_MAX = 0xFFFFFFFF


def mix32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche of a (hi, lo) k-mer pair, on int64 tensors holding
    u32 values (murmur3 finalizer core; the minimizer rank)."""
    h = ((hi * 0x9E3779B1) & U32_MAX) ^ ((lo * 0x85EBCA77) & U32_MAX)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & U32_MAX
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & U32_MAX
    return h ^ (h >> 16)


def _kmers(codes: torch.Tensor, k: int):
    """[R, Lc] int64 codes -> canonical k-mers of every start s < Lc-k+1:
    (rank h, canonical k-mer, strand, palindrome), each [R, S]."""
    S = codes.shape[1] - k + 1
    fwd = torch.zeros((codes.shape[0], S), dtype=torch.int64,
                      device=codes.device)
    rc = torch.zeros_like(fwd)
    for t in range(k):
        c = codes[:, t:t + S]
        fwd |= c << (2 * (k - 1 - t))
        rc |= (c ^ 3) << (2 * t)
    strand = fwd >= rc
    canon = torch.where(strand, rc, fwd)
    return mix32(canon >> 32, canon & U32_MAX), canon, strand, fwd == rc


def _sketch_reads_plain(codes, rids, k):
    rows = codes[rids].to(torch.int64)
    n, L = rows.shape
    S = L - k + 1
    out = torch.zeros((3, n), dtype=torch.int64, device=codes.device)
    if n == 0 or S <= 0:
        return out.to(torch.uint32)
    h, canon, strand, pal = _kmers(rows, k)
    h = torch.where(pal, U32_MAX, h)
    # the first minimum wins: rank and position as one key (S <= 256)
    s = (h * 512 + torch.arange(S, device=codes.device)).argmin(dim=1,
                                                                 keepdim=True)
    live = h.gather(1, s)[:, 0] != U32_MAX
    best = canon.gather(1, s)[:, 0]
    meta = ((s[:, 0] + k - 1) << 1) | strand.gather(1, s)[:, 0]
    for i, v in enumerate((best >> 32, best & U32_MAX, meta)):
        out[i] = torch.where(live, v, 0)
    return out.to(torch.uint32)


L_MAX = 256   # the longest read the read-minimizer kernel stages
RID_MAX = (1 << 31) - 1   # the kernel takes int32 rids
# rids from which the host's pass over them (the range check, the int32
# copy) runs on every core: below it, waking the threads costs more
HOST_PARALLEL = 1 << 17


def _check_reads(n_rows: int, rids: np.ndarray, k: int) -> np.ndarray:
    """The read minimizer's checks, on a host rid array (no device sync):
    ValueError for the rids' type or shape, or k; IndexError for a rid
    outside the read store. Returns the rids as int32 or int64, without a
    copy where they are one of those."""
    if rids.ndim != 1 or rids.dtype.kind not in "iu":
        raise ValueError(f"rids: want a 1-d integer array, got {rids.dtype} "
                         f"{rids.shape}")
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside [1, 31]")
    if rids.dtype not in (np.int32, np.int64):
        rids = rids.astype(np.int64)
    rids = np.ascontiguousarray(rids)
    if len(rids):
        lo, hi = (torch.aminmax(torch.from_numpy(rids))
                  if len(rids) >= HOST_PARALLEL else (rids.min(), rids.max()))
        if lo < 0 or hi >= n_rows:
            raise IndexError("rid outside the read store")
    return rids


def sketch_reads_flat(codes: torch.Tensor, rids: np.ndarray,
                      k: int) -> np.ndarray:
    """Whole-read canonical minimizer of the rows ``codes[rids]``, for the
    cluster rounds: the contract of ``sketch_reads_gather`` with the rids
    and the result as host arrays.

    codes: [N, L] uint8 read store (on the card L <= 256 and N <= 2^31 -
    1); rids: [n] integer host array, checked here. Returns [3, n] uint32.
    On the card, through one pinned buffer of 3n words: the rids go up as
    int32 in one copy, one launch, the result comes down in one copy into
    the same buffer (the copies and the launch are ordered on one stream);
    no other sync."""
    cuda.check(codes, torch.uint8, 2, "codes")
    rids = _check_reads(codes.shape[0], np.asarray(rids), k)
    if codes.device.type == "cpu":
        return _sketch_reads_plain(codes, torch.from_numpy(rids).to(
            torch.int64), k).numpy()
    N, L = codes.shape
    if L > L_MAX or N > RID_MAX:
        raise ValueError(f"a store of {N} reads of {L} bases: the kernel "
                         f"takes at most {RID_MAX} of {L_MAX}")
    cuda.require_cuda(codes)
    n = len(rids)
    if n == 0:
        return np.zeros((3, 0), np.uint32)
    buf = cuda.pinned(3 * n, torch.int32, codes.device)
    if n >= HOST_PARALLEL:
        buf[:n].copy_(torch.from_numpy(rids))
    else:
        np.copyto(buf.numpy()[:n], rids, casting="unsafe")
    out = torch.empty((3, n), dtype=torch.int32, device=codes.device)
    cuda.launch("mtc_sketch_reads", codes, L,
                cuda.to_device(buf[:n], codes.device, non_blocking=True), n,
                k, out)
    return cuda.to_host(out, buf.view(3, n)).numpy().view(np.uint32)


def sketch_reads_device(codes: torch.Tensor, rids: torch.Tensor,
                        k: int) -> torch.Tensor:
    """The read minimizer of ``sketch_reads_flat`` with the rids and the
    result left on the store's device: rids [n] int32; returns [3, n] int32
    holding the u32 words. One launch and no sync on the card, so the rids
    are not range checked there: each must lie in the store (the fused
    cluster step passes an arange)."""
    cuda.check(codes, torch.uint8, 2, "codes")
    cuda.check(rids, torch.int32, 1, "rids")
    if rids.device != codes.device:
        raise ValueError("codes and rids on different devices")
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside [1, 31]")
    if codes.device.type == "cpu":
        return _sketch_reads_plain(codes, rids.to(torch.int64), k).view(
            torch.int32)
    N, L = codes.shape
    if L > L_MAX or N > RID_MAX:
        raise ValueError(f"a store of {N} reads of {L} bases: the kernel "
                         f"takes at most {RID_MAX} of {L_MAX}")
    cuda.require_cuda(codes)
    out = torch.empty((3, len(rids)), dtype=torch.int32, device=codes.device)
    if len(rids):
        cuda.launch("mtc_sketch_reads", codes, L, rids, len(rids), k, out)
    return out


def sketch_reads_gather(codes: torch.Tensor, rids: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Whole-read canonical minimizer of the rows ``codes[rids]``.

    codes: [N, L] uint8 read store (codes 0..3, N substituted); rids: [n]
    int64. Returns [3, n] uint32 on the store's device: k-mer hi, k-mer lo,
    end_pos << 1 | strand of the minimum-rank k-mer, the first on ties;
    all zero for a read with no valid k-mer. Replaces
    ``sketch_reads_dyn_gather_packed``. ``sketch_reads_flat`` on the rids
    brought to the host, its result taken back to the store's device."""
    cuda.check(codes, torch.uint8, 2, "codes")
    cuda.check(rids, torch.int64, 1, "rids")
    if rids.device != codes.device:
        raise ValueError("codes and rids on different devices")
    out = sketch_reads_flat(codes, cuda.to_host(rids).numpy(), k)
    return cuda.to_device(out, codes.device)


def _sketch_windowed_plain(ref_flat, starts, lengths, Lmax, k, we, mb):
    dev = ref_flat.device
    rows = starts.shape[0]
    S = Lmax - k + 1
    we = min(we, S)
    col = torch.arange(Lmax, device=dev)
    inrow = col[None, :] < lengths[:, None].to(torch.int64)
    # positions past a row's end read the zero appended to the stream
    padded = torch.cat([ref_flat, ref_flat.new_zeros(1)])
    idx = (starts[:, None] + col[None, :]).clamp(max=len(ref_flat))
    codes = torch.where(inrow, padded[idx], 0)
    h, _, strand, pal = _kmers(codes.to(torch.int64), k)
    pos = torch.arange(S, device=dev)
    valid = ~pal & (pos[None, :] + k <= lengths[:, None])
    h = torch.where(valid, h, U32_MAX)
    # window minima over [j, j + we), clipped at the row end; a window with
    # no valid k-mer contributes nothing (0) to the covering maximum
    wmin = F.pad(h, (0, we - 1), value=U32_MAX).unfold(1, we, 1).amin(-1)
    wmin = torch.where(wmin == U32_MAX, 0, wmin)
    cover = F.pad(wmin, (we - 1, 0), value=0).unfold(1, we, 1).amax(-1)
    emitted = (cover == h) & (h != U32_MAX)
    order = emitted.cumsum(1)
    keep = emitted & (order <= mb)
    slot = torch.where(keep, order - 1, mb)
    meta = ((pos + k - 1) << 1)[None, :] | strand

    def first_mb(vals):
        out = torch.zeros((rows, mb + 1), dtype=torch.int64, device=dev)
        return out.scatter_(1, slot, torch.where(keep, vals, 0))[:, :mb]

    nv = order[:, -1].clamp(max=mb)
    return (first_mb(h).to(torch.uint32), first_mb(meta).to(torch.int32),
            nv.to(torch.int32))


_PLAIN_ROWS = 2048  # rows per call of the plain version in a flat sketch


def _sketch_windowed_flat_plain(ref_flat, starts, lengths, mb, k, w):
    """The plain version of ``sketch_windowed_flat``: the dense plain
    version on each run of rows with one slot count (at most _PLAIN_ROWS
    rows at a time), its kept entries compacted in row order."""
    dev = ref_flat.device
    keys, metas, nvs = [], [], []
    cuts = np.flatnonzero(mb[1:] != mb[:-1]) + 1
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(mb)]):
        for i in range(int(lo), int(hi), _PLAIN_ROWS):
            j = min(i + _PLAIN_ROWS, int(hi))
            lmax = max(int(lengths[i:j].max()), k)
            dense = _sketch_windowed_plain(
                ref_flat, cuda.to_device(starts[i:j], dev),
                cuda.to_device(lengths[i:j].astype(np.int32), dev),
                lmax, k, min(w, lmax - k + 1), int(mb[i]))
            key, meta, nv = (cuda.to_host(x).numpy() for x in dense)
            v = np.arange(mb[i])[None, :] < nv[:, None]
            keys.append(key[v])
            metas.append(meta[v])
            nvs.append(nv)
    return (np.concatenate(keys), np.concatenate(metas),
            np.concatenate(nvs).astype(np.int32))


def _check_rows(starts, lengths, n_ref, lmax=None):
    """IndexError unless every row lies inside the contig stream (and is at
    most ``lmax`` long): host arrays, so no device sync."""
    if len(starts) and (min(starts.min(), lengths.min()) < 0
                        or (starts + lengths).max() > n_ref
                        or (lmax is not None and lengths.max() > lmax)):
        raise IndexError("row outside the contig stream or the rung")


def _tiles(S: np.ndarray, short_max: int, per_tile: int) -> np.ndarray:
    """The first row of each block of one launch, then the row count: up to
    ``per_tile`` consecutive rows of at most ``short_max`` k-mer starts
    share a block (a warp each); any other row has a block of its own."""
    idx = np.arange(len(S))
    short = S <= short_max if short_max > 0 else np.zeros(len(S), bool)
    head = short & ~np.r_[False, short[:-1]]
    run0 = np.maximum.accumulate(np.where(head, idx, 0)) if len(S) else idx
    new = ~short | ((idx - run0) % per_tile == 0)
    return np.r_[np.flatnonzero(new), len(S)].astype(np.int64)


def _plan(starts, lengths, mb, soff, k, w):
    """Host side of one launch: the [R, 4] rows (start, len, mb, slot
    offset) then the tiles, as one int64 array; the tile count and the
    window the kernel sizes its shared memory for."""
    w_eff = int(max(1, min(w, lengths.max() - k + 1)))
    short_max, per_tile = cuda.sketch_layout(w_eff)
    tiles = _tiles(lengths.astype(np.int64) - k + 1, short_max, per_tile)
    desc = np.concatenate([np.stack([starts, lengths, mb, soff], 1).ravel(),
                           tiles]).astype(np.int64)
    return desc, len(tiles) - 1, w_eff


def _launch(ref_flat, desc, n_rows, n_tiles, k, w, stage, out=None,
            status=None):
    """One contig-sketch launch: ``stage`` = (key, meta, nv) tensors, and
    for the compacted layout ``out`` ([cap, 2] int32) and ``status`` (zeroed
    int64, one word per tile and the ticket)."""
    cuda.launch("mtc_sketch_windowed", ref_flat, desc, desc[4 * n_rows:],
                n_tiles, k, w, stage[0], stage[1], out, stage[2], status)


def sketch_windowed_compact32(ref_flat: torch.Tensor, starts: torch.Tensor,
                              lengths: torch.Tensor, Lmax: int, k: int,
                              we: int, mb: int):
    """(w, k)-minimizers with tie emission of the rows
    ``ref_flat[starts[r] : starts[r] + lengths[r]]`` (every length <= Lmax).

    Position i is emitted iff its rank equals the minimum of some window of
    ``we`` k-mer starts covering it (windows clipped at the row's end); the
    first ``mb`` emissions per row are kept in position order. Returns
    key32 [rows, mb] uint32 (the rank, mix32 of the canonical k-mer),
    meta [rows, mb] int32 (end_pos << 1 | strand) and nv [rows] int32
    (min(emissions, mb)). Slots at or beyond nv are undefined. Replaces
    ``gather_contig_rows`` + ``sketch_windowed_pallas_compact32``. On the
    card the rows' (start, length) come to the host for the checks and the
    plan (one copy each), and one launch writes the dense layout."""
    cuda.check(ref_flat, torch.uint8, 1, "ref_flat")
    cuda.check(starts, torch.int64, 1, "starts")
    cuda.check(lengths, torch.int32, 1, "lengths")
    if not (ref_flat.device == starts.device == lengths.device):
        raise ValueError("ref_flat, starts and lengths on different devices")
    if starts.shape != lengths.shape:
        raise ValueError("starts and lengths differ in length")
    if not (1 <= k <= 31 and k <= Lmax and we >= 1 and mb >= 1):
        raise ValueError(f"bad sketch shape k={k} Lmax={Lmax} we={we} "
                         f"mb={mb}")
    st, ln = cuda.to_host(starts).numpy(), cuda.to_host(lengths).numpy()
    _check_rows(st, ln, len(ref_flat), Lmax)
    if ref_flat.device.type == "cpu":
        return _sketch_windowed_plain(ref_flat, starts, lengths, Lmax, k, we,
                                      mb)
    cuda.require_cuda(ref_flat)
    dev = ref_flat.device
    rows = len(st)
    stage = (torch.empty((rows, mb), dtype=torch.uint32, device=dev),
             torch.empty((rows, mb), dtype=torch.int32, device=dev),
             torch.empty(rows, dtype=torch.int32, device=dev))
    if rows:
        desc, n_tiles, w_eff = _plan(st, ln, np.full(rows, mb),
                                     np.arange(rows) * mb, k,
                                     min(we, Lmax - k + 1))
        _launch(ref_flat, cuda.to_device(desc, dev), rows, n_tiles, k,
                w_eff, stage)
    return stage


def sketch_windowed_flat(ref_flat: torch.Tensor, starts: np.ndarray,
                         lengths: np.ndarray, mb: np.ndarray, k: int, w: int):
    """The contig sketch of ``sketch_windowed_compact32`` over rows of any
    lengths, each row r with its own slot count ``mb[r]``, the windows of
    row r min(w, its k-mer starts) wide; the kept entries compacted in row
    order.

    starts, lengths, mb: host arrays, one entry per row (checked here, on
    the host). Returns host arrays: key32 [n] uint32, meta [n] int32
    (end_pos << 1 | strand), nv [rows] int32 (min(emissions, mb[r])), where
    row r's nv[r] entries follow those of the rows before it, in position
    order. On the card: one upload of the rows, one launch that sketches
    every row and compacts on the card, one download of nv and one of the
    entries; a window wider than 6,481 starts on rows that long does not
    fit a block's shared memory, and the launch raises."""
    cuda.check(ref_flat, torch.uint8, 1, "ref_flat")
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    mb = np.asarray(mb, np.int64)
    if not starts.shape == lengths.shape == mb.shape or starts.ndim != 1:
        raise ValueError("starts, lengths and mb differ in shape")
    if not (1 <= k <= 31 and w >= 1 and (mb >= 1).all()):
        raise ValueError(f"bad sketch shape k={k} w={w}")
    _check_rows(starts, lengths, len(ref_flat))
    rows = len(starts)
    if rows == 0:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    if ref_flat.device.type == "cpu":
        return _sketch_windowed_flat_plain(ref_flat, starts, lengths, mb, k,
                                           w)
    cuda.require_cuda(ref_flat)
    dev = ref_flat.device
    soff = np.r_[0, np.cumsum(mb)[:-1]]
    cap = int(mb.sum())
    desc, n_tiles, w_eff = _plan(starts, lengths, mb, soff, k, w)
    stage = (torch.empty(cap, dtype=torch.uint32, device=dev),
             torch.empty(cap, dtype=torch.int32, device=dev),
             torch.empty(rows, dtype=torch.int32, device=dev))
    out = torch.empty((cap, 2), dtype=torch.int32, device=dev)
    status = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    _launch(ref_flat, cuda.to_device(desc, dev), rows, n_tiles, k,
            w_eff, stage, out, status)
    nv = cuda.to_host(stage[2]).numpy()
    ent = cuda.to_host(out[:int(nv.sum())]).numpy()
    return (np.ascontiguousarray(ent[:, 0]).view(np.uint32),
            np.ascontiguousarray(ent[:, 1]), nv)
