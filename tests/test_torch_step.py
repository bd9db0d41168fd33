"""The port's fused cluster step (minicom_tpu_torch.ops.step), in its plain
PyTorch version on the CPU, against the JAX package's ``cluster_step`` (an
XLA program, no Pallas, run on the CPU), exactly; the plain version of
each kernel against the whole step; and the kernels' work as numpy
executors of the segment scan's blocks and the vote's implicit tiles (every
column and every member written once)."""

import functools

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


def _run_segments(skey, order, mz, block):
    """The two kernels of mtc_step_segments, block by block: each block's
    (heads, max since the last head), then each block's scan seeded by the
    blocks before it. Returns what the kernels write."""
    N = len(skey)
    head = np.r_[True, skey[1:] != skey[:-1]]
    smz = mz[order]
    items = list(zip(head.astype(int), smz >> 1))
    ident = (0, -1)
    blocks = [items[b:b + block] for b in range(0, N, block)]
    agg = [functools.reduce(_combine, blk, ident) for blk in blocks]
    seg_id = np.full(N, -1, np.int64)
    first = np.full(N + 2, -1, np.int64)
    seg_max = np.full(N, -1, np.int64)
    for b, blk in enumerate(blocks):
        run = functools.reduce(_combine, agg[:b], ident)
        for j, it in enumerate(blk):
            i = b * block + j
            run = _combine(run, it)
            g = run[0] - 1
            seg_id[i] = g
            if it[0]:
                first[g] = i
            if i + 1 == N or head[i + 1]:
                seg_max[g] = run[1]
            if i + 1 == N:
                first[g + 1], first[N + 1] = N, g + 1
    return order.astype(np.int32), smz, seg_id, first, seg_max


@pytest.mark.parametrize("block", [7, 64, step.SEG_BLOCK])
@pytest.mark.parametrize("name", ["genome_k31", "copies_600",
                                  "at_rows_k30"])
def test_segment_scan_blocks_match_plain(name, block):
    codes, k, _ = _cases()[name]
    key, mz = step._minimizers_plain(torch.from_numpy(codes), k)
    skey, order = torch.sort(key, stable=True)
    want = [x.numpy() for x in step._segments_plain(skey, order, mz)]
    got = _run_segments(skey.numpy(), order.numpy(), mz.numpy(), block)
    nseg = len(want[3]) - 1
    assert got[3][len(codes) + 1] == nseg
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:len(w)], w)


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
