"""The port's fused cluster step (minicom_tpu_torch.ops.step), in its plain
PyTorch version on the CPU, against the JAX package's ``cluster_step`` (an
XLA program, no Pallas, run on the CPU), exactly; the plain version of
each kernel against the whole step; and the kernels' work as numpy
executors of the segment scan's tiles (ticket order, decoupled look-back)
and the vote's implicit tiles (every column and every member written
once)."""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minicom_tpu.ops.step import cluster_step as jax_cluster_step
from minicom_tpu_torch.ops import sketch, step
from tests._step_cases import step_cases
from tests.conftest import genome_reads

OUTPUTS = ("consensus", "coverage", "diffs", "seg_id", "order")


def _conftest_genome(rng, n, L):
    """tests/conftest.py::genome_reads (both strands, 1% errors) as codes."""
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    return lut[genome_reads(rng, n, L)]


@functools.lru_cache(maxsize=None)
def _cases():
    return step_cases(_conftest_genome)


def _jax(codes, k, span):
    return [np.asarray(x) for x in jax_cluster_step(jnp.asarray(codes), k,
                                                     span)]


def _port(codes, k, span):
    return [x.numpy() for x in step.cluster_step(torch.from_numpy(codes), k,
                                                 span)]


@pytest.mark.parametrize("name", list(step_cases()))
def test_plain_step_matches_jax(name):
    codes, k, span = _cases()[name]
    got, want = _port(codes, k, span), _jax(codes, k, span)
    for out, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, out
        np.testing.assert_array_equal(g, w, err_msg=out)


def test_cases_reach_the_rules():
    """The no-valid-k-mer rule, a deep segment, both span_cols edges."""
    cases = _cases()
    for name in ("at_rows_k30", "at_rows_k16", "palindromes_L16_k16"):
        codes, k, _ = cases[name]
        sk = sketch._sketch_reads_plain(torch.from_numpy(codes),
                                        torch.arange(len(codes)), k)
        assert (sk[2] == 0).sum() > len(codes) // 4, name
    codes, k, span = cases["copies_600"]
    seg_id = _port(codes, k, span)[3]
    assert np.bincount(seg_id).max() >= 600
    for name, below in (("span_below", True), ("span_above", False)):
        codes, k, span = cases[name]
        assert (span < codes.size * 2) == below


@pytest.mark.parametrize("name", ["genome_k16", "at_rows_k16",
                                  "palindromes_L16_k16", "copies_600"])
def test_keys_from_the_read_minimizer_match_all_kmers(name):
    """mtc_step_keys' plain version on kernel (c)'s words (its plain
    version, as on the card) gives the minimizer of all k-mers."""
    codes, k, _ = _cases()[name]
    c = torch.from_numpy(codes)
    sk = sketch.sketch_reads_device(c, torch.arange(len(c),
                                                    dtype=torch.int32), k)
    for g, w in zip(step._keys_plain(c, sk, k),
                    step._minimizers_plain(c, k)):
        assert torch.equal(g, w)


def _combine(a, b):
    return (a[0] + b[0], b[1] if b[0] else max(a[1], b[1]))


IDENT = (0, -1)


def _tile_scan(key, smz, i0, lanes, rows, warps):
    """One tile's work before its look-back, as mtc_step_segments' kernel
    does it: warp w owns items i0 + w rows lanes on, lane l item r lanes + l
    of row r; a head where a key differs from its left neighbour (lane 0 of
    row 0 reads the key before the warp); each row scanned in log2(lanes)
    steps, all lanes at once, that stop at the lane's segment start; the
    rows in order, then the warps. Returns each item's inclusive pair from
    the tile's first item, its head bit and the tile's pair."""
    N = len(key)
    heads, loc, warp_agg = {}, {}, []
    for w in range(warps):
        w0 = i0 + w * rows * lanes
        run = IDENT
        for r in range(rows):
            idx = [w0 + r * lanes + ln for ln in range(lanes)]
            mask = sum(1 << ln for ln, i in enumerate(idx)
                       if i < N and (i == 0 or key[i] != key[i - 1]))
            vals = [smz[i] >> 1 if i < N else -1 for i in idx]
            start = [max([b for b in range(ln + 1) if mask >> b & 1],
                         default=0) for ln in range(lanes)]
            d = 1
            while d < lanes:
                vals = [max(v, vals[ln - d]) if ln - d >= start[ln] else v
                        for ln, v in enumerate(vals)]
                d *= 2
            for ln, i in enumerate(idx):
                upto = bin(mask & ((2 << ln) - 1)).count("1")
                loc[i] = _combine(run, (upto, vals[ln]))
                heads[i] = bool(mask >> ln & 1)
            run = _combine(run, (bin(mask).count("1"), vals[-1]))
        warp_agg.append(run)
    base, out = IDENT, {}
    for w in range(warps):
        w0 = i0 + w * rows * lanes
        for i in range(w0, min(w0 + rows * lanes, N)):
            out[i] = _combine(base, loc[i])
        base = _combine(base, warp_agg[w])
    return out, heads, base


def _look_back(status, t, paths):
    """Tile t's exclusive pair from its predecessors' status words, 32 a
    step (a warp's lanes, nearest first), to the nearest that holds a
    visible inclusive prefix; each step's words combined in order."""
    before, top = IDENT, t - 1
    while True:
        window, stop = IDENT, False
        for p in range(top, max(top - 32, -1), -1):
            st = status[p]
            if t >= st["visible"]:
                window, stop = _combine(st["incl"], window), True
                paths["inclusive_stops"] += p > 0
                break
            window = _combine(st["agg"], window)
        before = _combine(window, before)
        if stop:
            return before
        top -= 32
        paths["crossed"] += 1


def _run_segments(skey, order, mz, tile, seed=0):
    """mtc_step_segments' one pass, tile by tile: tiles taken in ticket
    order (blocks start in any order and the block id is never used), each
    publishes its pair, then looks back (``_look_back``) and publishes its
    inclusive prefix. When the tiles after it see that prefix: tile 0 at
    once (it publishes nothing else); tiles 1-33 stall, 70 tickets late, so
    tile 34 combines 33 aggregates over two steps; from tile 34 on, even
    tiles at once and odd ones 1-70 tickets late (drawn from ``seed``), so
    look-backs stop at inclusive prefixes of tiles past 0. Returns what the
    kernel writes and the counts of those two paths."""
    N = len(skey)
    lanes = min(32, tile)
    rows = step.SEG_ROWS if tile == step.SEG_TILE else 1
    warps = tile // (lanes * rows)
    assert warps * rows * lanes == tile
    span = rows * lanes                     # a warp's items
    rng = np.random.default_rng(seed)
    smz = mz[order]
    key = [int(x) for x in skey]
    n_tiles = -(-N // tile)
    ticket = np.arange(n_tiles)
    late = np.where(ticket <= 33, 70,
                    np.where(ticket % 2, rng.integers(1, 71, n_tiles), 0))
    status = []
    seg_id = np.full(N, -1, np.int64)
    first = np.full(N + 2, -1, np.int64)
    seg_max = np.full(N, -1, np.int64)
    paths = {"inclusive_stops": 0, "crossed": 0}
    for t in range(n_tiles):                # the ticket
        i0 = t * tile
        loc, heads, agg = _tile_scan(key, smz, i0, lanes, rows, warps)
        before = _look_back(status, t, paths) if t else IDENT
        status.append({"agg": agg, "incl": _combine(before, agg),
                       "visible": t + late[t] if t else 0})
        for i in range(i0, min(i0 + tile, N)):
            h, mx = _combine(before, loc[i])
            g = h - 1
            seg_id[i] = g
            if heads[i]:
                first[g] = i
            # the next item's head bit, or past the warp the key after it
            nxt = i + 1 < N and (heads[i + 1] if (i + 1 - i0) % span
                                 else key[i + 1] != key[i])
            if i + 1 == N or nxt:
                seg_max[g] = mx
            if i + 1 == N:
                first[g + 1], first[N + 1] = N, g + 1
    return (order.astype(np.int32), smz, seg_id, first, seg_max), paths


@pytest.mark.parametrize("block", [7, 64, step.SEG_TILE])
@pytest.mark.parametrize("name", ["genome_k31", "copies_600",
                                  "at_rows_k30"])
def test_segment_scan_blocks_match_plain(name, block):
    """The one-pass scan's tiles (7 and 64 items, and the kernel's own),
    in ticket order with decoupled look-back, equal the plain version; at 7
    items a tile the look-back stops at some tile's inclusive prefix and
    reads past 32 predecessors."""
    codes, k, _ = _cases()[name]
    key, mz = step._minimizers_plain(torch.from_numpy(codes), k)
    skey, order = torch.sort(key, stable=True)
    want = [x.numpy() for x in step._segments_plain(skey, order, mz)]
    got, paths = _run_segments(skey.numpy(), order.numpy(), mz.numpy(),
                               block, seed=block)
    nseg = len(want[3]) - 1
    assert got[3][len(codes) + 1] == nseg
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:len(w)], w)
    if block == 7:
        assert paths["inclusive_stops"] > 0 and paths["crossed"] > 0


def test_seg_scratch_words():
    """A status word (two int32) a tile and one for the ticket: at least
    two words a tile of the scan, whose tile csrc/step.cu declares."""
    src = open(os.path.join(os.path.dirname(step.__file__), os.pardir,
                            "csrc", "step.cu")).read()
    const = {n: int(re.search(rf"constexpr int {n} = (\d+);", src)[1])
             for n in ("kSegThreads", "kSegRows")}
    assert const["kSegRows"] == step.SEG_ROWS
    assert const["kSegThreads"] * step.SEG_ROWS == step.SEG_TILE
    T = step.SEG_TILE
    for N, tiles in ((1, 1), (T, 1), (T + 1, 2), (5 * T - 1, 5),
                     ((1 << 31) - 1, (1 << 31) // T)):
        assert step.seg_scratch_words(N) == 2 * (tiles + 1)
        assert step.seg_scratch_words(N) >= 2 * -(-N // step.SEG_TILE)


def _orient(rows, z):
    rc = np.where(rows < 4, 3 - rows, rows)[:, ::-1]
    return np.where(z.astype(bool)[:, None], rc, rows)


def _run_vote_tiles(codes, order, smz, seg_id, first, seg_max, span):
    """mtc_step_vote's work items: the tile of slots [g0, g0 + G), for each
    g0 below nseg, counts its members' bases in its own columns (G 2L, fewer
    at N), votes, writes its columns below span_cols and its members' diffs,
    from its first members and segment maxima alone; then the columns from
    the last tile's end to span_cols are written as zeros. Every column
    below span_cols and every member must be written by exactly one item."""
    N, L = codes.shape
    G = step.tile_slots(L)
    assert (G * 2 * L) % 4 == 0
    nseg = len(first) - 1
    cons, cov = np.zeros(span, np.uint8), np.zeros(span, np.int32)
    diffs = np.zeros(N, np.int32)
    col_n, mem_n = np.zeros(span, int), np.zeros(N, int)
    for g0 in range(0, nseg, G):
        segs = min(G, nseg - g0)
        tile_first, tile_max = first[g0:g0 + segs + 1], seg_max[g0:g0 + segs]
        w0, width = g0 * 2 * L, (min(g0 + G, N) - g0) * 2 * L
        lo, hi = min(w0, span), min(w0 + width, span)
        col_n[lo:hi] += 1
        m = np.arange(tile_first[0], tile_first[-1])
        g = seg_id[m] - g0
        assert ((g >= 0) & (g < segs)).all()
        oc = _orient(codes[order[m]].astype(np.int64), smz[m] & 1)
        p = (g * 2 * L + tile_max[g] - (smz[m] >> 1))[:, None] + np.arange(L)
        assert p.min() >= 0 and p.max() < width
        cnt = np.zeros((width, 4), np.int64)
        np.add.at(cnt, (p, oc), 1)
        vote = cnt.argmax(axis=1)   # the first maximum
        vote[w0 + np.arange(width) >= span] = 255
        cons[lo:hi] = vote[:hi - lo]
        cov[lo:hi] = cnt.sum(axis=1)[:hi - lo]
        diffs[m] = (vote[p] != oc).sum(axis=1)
        mem_n[m] += 1
    col_n[min(-(-nseg // G) * G, N) * 2 * L:] += 1   # zeros
    assert (col_n == 1).all() and (mem_n == 1).all()
    return cons, cov, diffs


@pytest.mark.parametrize("name", ["random_128x48_k17", "genome_k17",
                                  "copies_600", "at_rows_k16",
                                  "palindromes_L16_k16", "span_below",
                                  "span_above"])
def test_vote_tiles_match_jax(name):
    codes, k, span = _cases()[name]
    key, mz = step._minimizers_plain(torch.from_numpy(codes), k)
    skey, order = torch.sort(key, stable=True)
    order32, smz, seg_id, first, seg_max = (
        x.numpy() for x in step._segments_plain(skey, order, mz))
    got = _run_vote_tiles(codes, order32, smz, seg_id, first, seg_max, span)
    want = _jax(codes, k, span)
    for out, g, w in zip(OUTPUTS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=out)


def test_tile_slots_align_columns():
    for L in range(1, 257):
        G = step.tile_slots(L)
        assert G >= 2 and (G * 2 * L) % 4 == 0
        assert G * 2 * L <= max(step.TILE_COLS, 4 * L)


@pytest.mark.parametrize("shape,k,span", [
    ((4, 20), 0, 160), ((4, 20), 32, 160), ((4, 20), 21, 160),
    ((0, 20), 5, 160), ((4, 20), 5, 0)])
def test_limits_raise_value_error(shape, k, span):
    with pytest.raises(ValueError):
        step.cluster_step(torch.zeros(shape, dtype=torch.uint8), k, span)


def test_int32_columns_limit():
    """N 2L columns must fit int32, as the JAX program's do."""
    step._check(10_737_418, 100, 31, 1)
    with pytest.raises(ValueError):
        step._check(10_737_419, 100, 31, 1)


def test_wrong_dtype_raises_value_error():
    with pytest.raises(ValueError):
        step.cluster_step(torch.zeros((4, 20), dtype=torch.int64), 5, 160)
