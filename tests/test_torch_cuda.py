"""The CUDA kernels of minicom_tpu_torch against their plain PyTorch versions,
on the card. Needs a CUDA device and nvcc; skipped without a device. On the
card (which has no jax, so without the repo conftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
    python -m pytest tests/test_torch_cuda.py --noconftest -q -k rans

(the second: the rANS kernels alone, seconds; ``-k sketch`` and ``-k
consensus`` take the other kernels alone, ``-k sketch_reads`` the read
minimizer, ``-k step`` the fused cluster step, ``-k mesh`` the sharded step
in two ranks on one card, ``-k cards`` in two ranks on two cards (NCCL;
skipped with fewer cards), ``-k accounting`` the counted crossings between
host and card, ``-k kernel_bench`` the kernel table of
``tools/kernel_bench_torch.py`` at an eighth of its sizes).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import configs_torch
from minicom_tpu_torch import CompressorConfig, compressor
from minicom_tpu_torch.entropy import backend, device_ctx_rans, device_rans
from minicom_tpu_torch.ops import cuda, rans, step
from minicom_tpu_torch.ops.consensus import (TILE, consensus_vote,
                                             consensus_vote_flat)
from minicom_tpu_torch.ops.rans import (LANES, M, rans_decode,
                                        rans_decode_blocks,
                                        rans_encode_blocks)
from minicom_tpu_torch.ops.sketch import (_sketch_reads_plain,
                                          sketch_reads_device,
                                          sketch_reads_flat,
                                          sketch_reads_gather,
                                          sketch_windowed_compact32,
                                          sketch_windowed_flat)
from minicom_tpu_torch.ops.verify import popcount_verify


def _load_helper(name):
    """A helper module of tests/ by its file (the card's site-packages may
    hold another package named tests)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_step_cases = _load_helper("_step_cases")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [4, 17, 30, 31])
def test_sketch_reads_kernel_matches_plain(dev, k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (3000, 100), dtype=np.uint8)
    codes[:5] = np.tile([0, 3], 50)[None, :]   # all-palindromic at even k
    c = torch.from_numpy(codes)
    r = torch.from_numpy(rng.integers(0, 3000, 5000))
    want = sketch_reads_gather(c, r, k).numpy()
    n0 = cuda.launches["mtc_sketch_reads"]
    got = sketch_reads_gather(c.to(dev), r.to(dev), k).cpu().numpy()
    assert cuda.launches["mtc_sketch_reads"] == n0 + 1
    np.testing.assert_array_equal(got, want)


def _reads_store(rng, n, L):
    codes = rng.integers(0, 4, (n, L), dtype=np.uint8)
    codes[:64] = np.resize(np.array([0, 3], np.uint8), L)   # palindromic
    codes[64:96] = 2                                         # one base
    return codes


def _entries_equal_plain(c, rids, k):
    """Both entries on the card, one launch each, equal to the plain
    version on the card's tensors."""
    r = torch.from_numpy(rids).to(c.device)
    want = _sketch_reads_plain(c, r, k).cpu().numpy()
    n0 = cuda.launches["mtc_sketch_reads"]
    flat = sketch_reads_flat(c, rids, k)
    assert cuda.launches["mtc_sketch_reads"] == n0 + 1
    got = sketch_reads_gather(c, r, k).cpu().numpy()
    assert cuda.launches["mtc_sketch_reads"] == n0 + 2
    np.testing.assert_array_equal(flat, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,L,n", [(1 << 17, 100, 1 << 17),
                                   (1 << 17, 100, 1), (1 << 17, 100, 33),
                                   (1 << 17, 100, 255)])
def test_sketch_reads_entries_at_phase1_shapes(dev, N, L, n):
    """chip_smoke's phase 1 shapes at L = 100: both entries, one launch a
    call, equal to the plain version for k in (31, 17, 4, 30)."""
    rng = np.random.default_rng(N + L + n)
    codes = _reads_store(rng, N, L)
    rids = rng.permutation(N)[:n] if n == N else rng.integers(0, N, n)
    c = torch.from_numpy(codes).to(dev)
    for k in (31, 17, 4, 30):
        _entries_equal_plain(c, rids, k)


def _reads_for_lanes(dev):
    """chip_smoke.reads_for_lanes: read counts that the kernel's rule
    (kFillReads = 256 reads an SM) gives 1, 2 and 4 lanes a read, the first
    past what the card holds at once."""
    fill = 256 * torch.cuda.get_device_properties(dev).multi_processor_count
    return {1: 8 * fill + 33, 2: fill - 1, 4: fill // 2 - 1}


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("L", [36, 100, 101, 150, 256])
def test_sketch_reads_lanes_match_plain(dev, lanes, L):
    """As many reads as the kernel gives 1, 2 or 4 lanes a read, on row
    starts off 4-byte alignment (odd L, L = 150) and read counts that leave
    a warp part full."""
    rng = np.random.default_rng(lanes * 1000 + L)
    codes = _reads_store(rng, 3001, L)
    rids = rng.integers(0, 3001, _reads_for_lanes(dev)[lanes])
    c = torch.from_numpy(codes).to(dev)
    for k in (31, 24, 17, 16, 4, 30, 1):
        _entries_equal_plain(c, rids, k)


@pytest.mark.parametrize("L,ks", [(50, (17, 23, 25, 31)),
                                  (75, (17, 23, 25, 31)),
                                  (100, (23, 25)), (101, (23, 25)),
                                  (150, (23, 25)), (256, (23, 25))])
def test_sketch_reads_at_the_configurations_shapes(dev, L, ks):
    """The read lengths and k of CONFIGS_torch.json's entries that the
    cells never give the kernel, at 1, 2 and 4 lanes a read."""
    rng = np.random.default_rng(L * 7)
    codes = _reads_store(rng, 3001, L)
    c = torch.from_numpy(codes).to(dev)
    for m in _reads_for_lanes(dev).values():
        rids = rng.integers(0, 3001, m)
        for k in ks:
            _entries_equal_plain(c, rids, k)


@pytest.mark.parametrize("Lmax,k,w", [(128, 31, 19), (512, 17, 11),
                                      (2048, 4, 3), (8192, 31, 19),
                                      (512, 31, 300)])
def test_sketch_windowed_kernel_matches_plain(dev, Lmax, k, w):
    rng = np.random.default_rng(Lmax + k)
    ref = rng.integers(0, 4, 200_000, dtype=np.uint8)
    ref[1000:1400] = np.tile([0, 3], 200)      # palindromes at even k
    rows = 300
    lens = rng.integers(0, Lmax + 1, rows).astype(np.int32)
    lens[:4] = [0, 1, k - 1, Lmax]
    starts = rng.integers(0, len(ref) - Lmax, rows).astype(np.int64)
    starts[4] = 1000
    mb = 64
    we = min(w, Lmax - k + 1)
    args = (torch.from_numpy(ref), torch.from_numpy(starts),
            torch.from_numpy(lens))
    wk, wm, wn = (x.numpy() for x in sketch_windowed_compact32(
        *args, Lmax, k, we, mb))
    gk, gm, gn = (x.cpu().numpy() for x in sketch_windowed_compact32(
        *(a.to(dev) for a in args), Lmax, k, we, mb))
    np.testing.assert_array_equal(gn, wn)
    v = np.arange(mb)[None, :] < wn[:, None]
    np.testing.assert_array_equal(gk[v], wk[v])
    np.testing.assert_array_equal(gm[v], wm[v])


@pytest.mark.parametrize("k,w", [(31, 19), (17, 300), (4, 3), (21, 40)])
def test_sketch_windowed_flat_kernel_matches_plain(dev, k, w):
    """A mixed-rung batched call in plan order (rows sorted by length, each
    rung's mb), with empty rows, rows shorter than k, saturated rows,
    palindromes and a long repeat: one launch, compacted entries equal to
    the batched plain version."""
    rng = np.random.default_rng(k + w)
    ref = rng.integers(0, 4, 300_000, dtype=np.uint8)
    ref[1000:1400] = np.tile([0, 3], 200)
    ref[5000:9000] = 2
    lens = np.sort(np.r_[rng.integers(0, 129, 3000),
                         rng.integers(129, 513, 700),
                         rng.integers(513, 2049, 120),
                         rng.integers(2049, 8193, 20), [0, 1, k - 1, 4000]])
    starts = rng.integers(0, len(ref) - 8192, len(lens))
    starts[-1] = 5000
    starts[:3] = 1000
    mb = np.select([lens <= 128, lens <= 512], [24, 64], 128)
    t = torch.from_numpy(ref)
    want = sketch_windowed_flat(t, starts, lens, mb, k, w)
    n0 = cuda.launches["mtc_sketch_windowed"]
    got = sketch_windowed_flat(t.to(dev), starts, lens, mb, k, w)
    assert cuda.launches["mtc_sketch_windowed"] == n0 + 1
    assert (got[2] >= mb).any()
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("k,w", [(17, 3), (17, 20), (23, 5), (25, 15),
                                 (25, 20), (31, 97)])
def test_sketch_windowed_flat_at_the_configurations_windows(dev, k, w):
    """The (k, w) of CONFIGS_torch.json's entries, on rows of every rung up
    to 32,768 bases (a 256 bp run's contigs reach ~7,400 at 200,000
    reads), each with the merge stage's slot count (``_batch_m``, cap 128):
    one launch, equal to the batched plain version."""
    from minicom_tpu_torch.pipeline.merge import _batch_m, _lmax_bucket
    rng = np.random.default_rng(k * 100 + w)
    lens = np.sort(np.r_[rng.integers(0, 129, 600),
                         rng.integers(129, 513, 300),
                         rng.integers(513, 2049, 100),
                         rng.integers(2049, 8193, 30),
                         rng.integers(8193, 32769, 6), [0, 1, k - 1]])
    ref = rng.integers(0, 4, int(lens.sum()) + 1000, dtype=np.uint8)
    ref[:600] = np.resize(np.array([0, 3], np.uint8), 600)
    starts = np.r_[0, np.cumsum(lens)[:-1]]
    mb = np.array([_batch_m(_lmax_bucket(max(int(n), k + 1)), k, w, 128)
                   for n in lens])
    t = torch.from_numpy(ref)
    want = sketch_windowed_flat(t, starts, lens, mb, k, w)
    n0 = cuda.launches["mtc_sketch_windowed"]
    got = sketch_windowed_flat(t.to(dev), starts, lens, mb, k, w)
    assert cuda.launches["mtc_sketch_windowed"] == n0 + 1
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


def test_sketch_contigs_is_one_launch_per_call(dev):
    """The merge stage's sketch of contigs of every rung: one launch for
    all its chunks, arrays equal to the CPU run's."""
    from minicom_tpu_torch.pipeline.cluster import ClusterSet
    from minicom_tpu_torch.pipeline.merge import sketch_contigs
    rng = np.random.default_rng(9)
    lens = rng.choice([100, 300, 1500, 6000], 5000, p=[.6, .3, .08, .02])
    ptr = np.r_[0, np.cumsum(lens)]
    cs = ClusterSet(100, np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.int8), np.zeros(len(lens) + 1, np.int64),
                    rng.integers(0, 4, int(ptr[-1]), dtype=np.uint8), ptr)
    want = sketch_contigs(cs, 31, 19, 128, torch.device("cpu"))
    n0 = cuda.launches["mtc_sketch_windowed"]
    got = sketch_contigs(cs, 31, 19, 128, dev)
    assert cuda.launches["mtc_sketch_windowed"] == n0 + 1
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("want_ref,want_diffs",
                         [(True, True), (True, False), (False, True)])
def test_consensus_kernel_matches_plain(dev, want_ref, want_diffs):
    rng = np.random.default_rng(int(want_ref) * 2 + int(want_diffs))
    N, L, C = 4000, 100, 300
    codes = rng.integers(0, 4, (N, L), dtype=np.uint8)
    sizes = rng.integers(1, 40, C)
    seg = np.repeat(np.arange(C), sizes)
    off = rng.integers(0, 60, len(seg))
    off[np.r_[0, np.cumsum(sizes)[:-1]]] = 0
    span = np.zeros(C + 1, np.int64)
    mx = np.zeros(C, np.int64)
    np.maximum.at(mx, seg, off)
    np.cumsum(mx + L, out=span[1:])
    rd = rng.integers(0, N, len(seg)) * 2 + rng.integers(0, 2, len(seg))
    col = span[seg] + off
    args = [torch.from_numpy(a) for a in (codes, rd, col)]
    want = consensus_vote(*args, int(span[-1]), want_ref, want_diffs)
    got = consensus_vote(*(a.to(dev) for a in args), int(span[-1]),
                         want_ref, want_diffs)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _flat_case(rng, sizes, spread, N=5000, L=100):
    """Clusters of ``sizes`` members, first columns drawn from 0..spread
    (one member at 0 and, with two or more, one at spread), members
    shuffled within a cluster."""
    codes = rng.integers(0, 4, (N, L), dtype=np.uint8)
    codes[rng.random((N, L)) < 0.01] = 4
    seg = np.repeat(np.arange(len(sizes)), sizes)
    seg_ptr = np.r_[0, np.cumsum(sizes)].astype(np.int64)
    off = rng.integers(0, np.repeat(spread, sizes) + 1)
    off[seg_ptr[1:] - 1] = spread
    off[seg_ptr[:-1]] = 0
    for a, b in zip(seg_ptr[:-1], seg_ptr[1:]):
        off[a:b] = rng.permutation(off[a:b])
    mx = np.zeros(len(sizes), np.int64)
    np.maximum.at(mx, seg, off)
    col_ptr = np.r_[0, np.cumsum(mx + L)].astype(np.int64)
    rd = rng.integers(0, N, len(seg)) * 2 + rng.integers(0, 2, len(seg))
    return codes, rd, col_ptr[seg] + off, seg_ptr, col_ptr


def _flat_equal(dev, codes, rd, col, seg_ptr, col_ptr, wants=((True,
                                                               True),)):
    span = int(col_ptr[-1])
    c, d = torch.from_numpy(codes), torch.from_numpy(codes).to(dev)
    for want_ref, want_diffs in wants:
        want = consensus_vote_flat(c, rd, col, seg_ptr, col_ptr, span,
                                   want_ref, want_diffs)
        n0 = cuda.launches["mtc_consensus_vote"]
        got = consensus_vote_flat(d, rd, col, seg_ptr, col_ptr, span,
                                  want_ref, want_diffs)
        assert cuda.launches["mtc_consensus_vote"] == n0 + 1
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(g, w)


def test_consensus_flat_kernel_matches_plain(dev):
    """Round-like clusters of ~100 columns, medium ones and a few many
    tiles wide, every want pair: one launch each, equal to the plain
    version."""
    rng = np.random.default_rng(21)
    sizes = np.r_[rng.integers(2, 30, 3000), rng.integers(10, 80, 40),
                  rng.integers(100, 900, 5)]
    spread = np.r_[rng.integers(0, 60, 3000), rng.integers(1000, 1900, 40),
                   rng.integers(3000, 12000, 5)]
    _flat_equal(dev, *_flat_case(rng, sizes, spread),
                ((True, True), (True, False), (False, True)))


def test_consensus_one_wide_segment(dev):
    """One cluster of 20,000 columns and 3,000 members in no order."""
    rng = np.random.default_rng(22)
    case = _flat_case(rng, np.array([3000]), np.array([19_900]))
    assert case[4][-1] == 20_000
    _flat_equal(dev, *case)


def test_consensus_member_split_across_tiles(dev):
    """Members that straddle the first tile boundary of a wide cluster, on
    both strands, and nothing else near it."""
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, (50, 100), dtype=np.uint8)
    col = np.r_[0, TILE - 40, TILE - 99, TILE - 1, 2 * TILE]
    rd = np.array([0, 2, 5, 7, 8])
    _flat_equal(dev, codes, rd, col, np.array([0, 5]),
                np.array([0, 2 * TILE + 100]),
                ((True, True), (False, True)))


def test_consensus_members_shuffled_across_segments(dev):
    """The tensor entry with members of many clusters in a random order
    (one cluster to it): equal to the plain version, one launch."""
    rng = np.random.default_rng(24)
    codes, rd, col, _, col_ptr = _flat_case(rng, rng.integers(1, 40, 500),
                                            rng.integers(0, 300, 500))
    p = rng.permutation(len(rd))
    args = [torch.from_numpy(a) for a in (codes, rd[p], col[p])]
    want = consensus_vote(*args, int(col_ptr[-1]))
    n0 = cuda.launches["mtc_consensus_vote"]
    got = consensus_vote(*(a.to(dev) for a in args), int(col_ptr[-1]))
    assert cuda.launches["mtc_consensus_vote"] == n0 + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("L", [50, 75, 101, 256])
def test_consensus_at_the_configurations_read_lengths(dev, L):
    """The read lengths of CONFIGS_torch.json's entries, whose rows are
    not a multiple of 4 bytes long (but 256, whose clusters are longer):
    round-like clusters and a few tiles wide, every want pair."""
    rng = np.random.default_rng(L)
    sizes = np.r_[rng.integers(2, 30, 1500), rng.integers(10, 80, 20)]
    spread = np.r_[rng.integers(0, L, 1500), rng.integers(1000, 3000, 20)]
    _flat_equal(dev, *_flat_case(rng, sizes, spread, L=L),
                ((True, True), (True, False), (False, True)))


def test_consensus_one_launch_per_call_in_compress(dev, tmp_path):
    """A compress makes one consensus launch per consensus_from_members
    call (cluster rounds and merge re-votes) and writes the CPU's
    archive."""
    from bench import make_dataset
    from minicom_tpu_torch.pipeline import cluster, merge
    fq = str(tmp_path / "in.fastq")
    make_dataset(fq, 20_000)
    calls, fn = [], cluster.consensus_from_members

    def counted(*a, **k):
        calls.append(len(a[1]))
        return fn(*a, **k)

    cluster.consensus_from_members = merge.consensus_from_members = counted
    try:
        a, launched = _cuda_equals_cpu(dev, tmp_path, CompressorConfig(), fq)
    finally:
        cluster.consensus_from_members = merge.consensus_from_members = fn
    n_cuda = len(calls) // 2          # the cuda run's calls come first
    assert all(calls[:n_cuda])
    assert launched["mtc_consensus_vote"] == n_cuda > 0


def test_wrappers_refuse_other_devices(dev):
    codes = torch.zeros((4, 10), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        sketch_reads_gather(codes, torch.zeros(2, dtype=torch.int64), 5)
    with pytest.raises(ValueError):
        sketch_reads_device(codes, torch.zeros(2, dtype=torch.int32), 5)


STEP_KERNELS = ("mtc_sketch_reads", "mtc_step_keys", "mtc_step_segments",
                "mtc_step_vote")
STEP_CASES = _step_cases.step_cases()


def _step_once(c, k, span):
    """cluster_step on the card: one launch of each of its four kernels."""
    n0 = {x: cuda.launches[x] for x in STEP_KERNELS}
    got = step.cluster_step(c, k, span)
    launched = {x: cuda.launches[x] - n0[x] for x in STEP_KERNELS}
    assert launched == dict.fromkeys(STEP_KERNELS, 1)
    return [x.cpu().numpy() for x in got]


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_kernels_match_plain(dev, name):
    codes, k, span = STEP_CASES[name]
    c = torch.from_numpy(codes).to(dev)
    got = _step_once(c, k, span)
    for g, w in zip(got, step._cluster_step_plain(c, k, span)):
        np.testing.assert_array_equal(g, w.cpu().numpy())


def test_step_pieces_over_several_tiles_and_scan_blocks(dev):
    """20,000 genome reads, 6,000 of them one read (a segment across the
    segment scan's tiles): each kernel against its plain version
    on the same inputs, the vote at span_cols below, at and above N 2L."""
    rng = np.random.default_rng(5)
    N, L, k = 20_000, 100, 31
    codes = _step_cases.genome_codes(rng, N, L, genome_len=200_000)
    codes[rng.permutation(N)[:6000]] = codes[0]
    c = torch.from_numpy(codes).to(dev)
    sk = sketch_reads_device(c, torch.arange(N, dtype=torch.int32,
                                             device=dev), k)
    key, mz = step._keys(c, sk, k)
    for g, w in zip((key, mz), step._keys_plain(c, sk, k)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    skey, order = torch.sort(key, stable=True)
    got = step._segments(skey, order, mz)
    want = step._segments_plain(skey, order, mz)
    nseg = len(want[3]) - 1
    assert N > 2 * step.SEG_TILE and nseg > 4 * step.tile_slots(L)
    assert int(got[3][N + 1]) == nseg
    for g, w, n in zip(got, want, (N, N, N, nseg + 1, nseg)):
        np.testing.assert_array_equal(g[:n].cpu().numpy(), w.cpu().numpy())
    for span in (N * 2 * L, N * 2 * L // 5 + 3, N * 2 * L + 9999):
        out = step._vote(c, *got, span)
        ref = step._vote_plain(c, *want[:3], want[4], span)
        for g, w in zip(out, ref):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def _seg_inputs(dev, sizes, seed=0):
    """Sorted keys in segments of ``sizes`` (gaps between keys drawn at
    random, some past 2^32), a random permutation and mz in [0, 2^9), on
    the card."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(1, 1 << 34, len(sizes), dtype=np.int64)
    skey = np.repeat(np.cumsum(gaps), sizes)
    N = len(skey)
    return (torch.from_numpy(skey).to(dev),
            torch.from_numpy(rng.permutation(N)).to(dev),
            torch.from_numpy(rng.integers(0, 1 << 9, N, dtype=np.int32)
                             ).to(dev))


def _segments_equal_plain(got, skey, order, mz):
    """mtc_step_segments' outputs against _segments_plain's: order32, smz,
    seg_id, first[0 .. nseg], nseg at first[N + 1], seg_max[0 .. nseg)."""
    N = len(skey)
    want = step._segments_plain(skey, order, mz)
    nseg = len(want[3]) - 1
    assert int(got[3][N + 1]) == nseg
    for g, w, n in zip(got, want, (N, N, N, nseg + 1, nseg)):
        np.testing.assert_array_equal(g[:n].cpu().numpy(), w.cpu().numpy())


def _seg_sizes(rng, N, most=5):
    sizes = rng.integers(1, most + 1, N)
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), N) + 1]
    sizes[-1] -= sizes.sum() - N
    return sizes


@pytest.mark.parametrize("N", [1, step.SEG_TILE - 1, step.SEG_TILE,
                               step.SEG_TILE + 1])
def test_segments_kernel_at_tile_edges(dev, N):
    skey, order, mz = _seg_inputs(dev, _seg_sizes(np.random.default_rng(N),
                                                  N), N)
    _segments_equal_plain(step._segments(skey, order, mz), skey, order, mz)


def test_segments_kernel_one_segment_over_three_tiles(dev):
    """A segment from the middle of tile 0 to the middle of tile 3, among
    segments of 1-5 members."""
    T = step.SEG_TILE
    rng = np.random.default_rng(3)
    sizes = np.concatenate([_seg_sizes(rng, T // 2), [3 * T],
                            _seg_sizes(rng, T)])
    skey, order, mz = _seg_inputs(dev, sizes, 3)
    got = step._segments(skey, order, mz)
    _segments_equal_plain(got, skey, order, mz)
    seg_id = got[2].cpu().numpy()
    assert len(np.unique(seg_id[T // 2:T // 2 + 3 * T])) == 1


def test_segments_kernel_every_read_its_own(dev):
    N = 5 * step.SEG_TILE + 3
    skey, order, mz = _seg_inputs(dev, np.ones(N, np.int64), 4)
    got = step._segments(skey, order, mz)
    _segments_equal_plain(got, skey, order, mz)
    assert int(got[3][N + 1]) == N


def test_segments_kernel_more_tiles_than_the_card_holds(dev):
    """N odd and above 2^22: more tiles than the card runs at once, so
    blocks start as others end, and a look-back meets predecessors that
    have ended, that hold only their own reduction, and that have not
    published yet."""
    N = (1 << 22) + (1 << 20) + 1
    prop = torch.cuda.get_device_properties(dev)
    at_once = prop.multi_processor_count * (
        prop.max_threads_per_multi_processor // 256)
    assert -(-N // step.SEG_TILE) > at_once
    skey, order, mz = _seg_inputs(dev, _seg_sizes(
        np.random.default_rng(5), N, most=9), 5)
    _segments_equal_plain(step._segments(skey, order, mz), skey, order, mz)


def _seg_outputs(N, dev):
    buf = torch.empty(step.seg_scratch_words(N) + 5 * N + 2,
                      dtype=torch.int32, device=dev)
    return buf.split([step.seg_scratch_words(N), N, N, N, N + 2, N])


def test_segments_kernel_twice_on_one_scratch(dev):
    """Two calls on one scratch and one set of outputs, other inputs the
    second time: the status words and the ticket start afresh."""
    N = 3 * step.SEG_TILE + 77
    scratch, *outs = _seg_outputs(N, dev)
    for seed in (6, 7):
        skey, order, mz = _seg_inputs(dev, _seg_sizes(
            np.random.default_rng(seed), N), seed)
        cuda.launch("mtc_step_segments", skey, order, mz, N, scratch, *outs)
        _segments_equal_plain(outs, skey, order, mz)


def test_segments_kernel_graph_replays(dev):
    """A CUDA graph of one launch, replayed five times on one scratch, the
    outputs overwritten with -7 before each replay: the same outputs every
    time, equal to the plain version's."""
    N = 7 * step.SEG_TILE + 5
    skey, order, mz = _seg_inputs(dev, _seg_sizes(
        np.random.default_rng(8), N, most=40), 8)
    scratch, *outs = _seg_outputs(N, dev)

    def run():
        cuda.launch("mtc_step_segments", skey, order, mz, N, scratch, *outs)

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    for _ in range(5):
        for x in outs:
            x.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        _segments_equal_plain(outs, skey, order, mz)


def test_step_refuses_long_reads_on_the_card(dev):
    codes = torch.zeros((4, 300), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        step.cluster_step(codes, 31, 4 * 600)


MESH_CASES = _step_cases.mesh_cases()


def _cards(n):
    """The environment of a group that sees the first ``n`` cards of this
    host: its ranks share them (``distributed.place``)."""
    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = seen.split(",") if seen else [str(i) for i in range(n)]
    return {"CUDA_VISIBLE_DEVICES": ",".join(ids[:n])}


def _mesh_group(tmp, cards, device):
    """Two ranks that see ``cards`` cards run the sharded step on every
    case of ``mesh_cases`` on ``device``: per rank, its outputs and each
    case's launches and stats."""
    worker = _load_helper("_torch_dist_worker")
    cases = os.path.join(tmp, "cases.npz")
    worker.write_mesh_cases(cases, MESH_CASES, _step_cases.mesh_split)
    res = worker.run_group(tmp, "m2", 2, [dict(
        op="mesh", cases=cases, device=device,
        out=os.path.join(tmp, "m2_{rank}.npz"))], env=_cards(cards))
    ranks = []
    for r in range(2):
        with np.load(os.path.join(tmp, f"m2_{r}.npz")) as z:
            ranks.append(({f: z[f] for f in z.files},
                          worker.job_results(res, r)[0]))
    return ranks


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """Two ranks on cuda:0 (gloo), the group seeing one card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _mesh_group(str(tmp_path_factory.mktemp("mesh")), 1, "cuda:0")


@pytest.fixture(scope="module")
def cards_ranks(tmp_path_factory):
    """Two ranks on two cards, each on its own ("cuda": cuda:0 and cuda:1),
    the exchanges over NCCL."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA devices, {torch.cuda.device_count()} "
                    "here")
    return _mesh_group(str(tmp_path_factory.mktemp("cards")), 2, "cuda")


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_two_ranks_equal_one_card(dev, mesh_ranks, name):
    """The rank-order concatenation of the two ranks' outputs equals the
    one-card cluster_step's, consensus and coverage whole on each rank;
    each rank launched kernel (c) and the keys kernel once if it holds
    rows, the segments kernel once, and the vote once if it owns a segment
    with columns below span_cols, and nothing else."""
    codes, k, span = MESH_CASES[name]
    want = _step_once(torch.from_numpy(codes).to(dev), k, span)
    for i, w in enumerate(want):
        parts = [outs[f"{name}/{i}"] for outs, _ in mesh_ranks]
        for g in (parts if i < 2 else [np.concatenate(parts)]):
            np.testing.assert_array_equal(g, w)
    for _, res in mesh_ranks:
        owned = res[name]["owned"]
        held = int(owned["rows"] > 0)
        assert res[name]["launched"] == {x: n for x, n in (
            ("mtc_sketch_reads", held), ("mtc_step_keys", held),
            ("mtc_step_segments", 1),
            ("mtc_step_vote", int(owned["voted"]))) if n}
        assert set(res[name]["device_ms"]) >= {"sort", "segments"}
        assert res[name]["backend"] == "gloo"


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_cards_two_ranks_over_nccl_equal_one_card(dev, cards_ranks, name):
    """Rank r on cuda:r: the rank-order concatenation of the two ranks'
    outputs equals the one-card cluster_step's, consensus and coverage
    whole on each; each rank's exchanges went over NCCL and moved no byte
    through the host, and its device ms were taken on its card."""
    codes, k, span = MESH_CASES[name]
    want = _step_once(torch.from_numpy(codes).to(dev), k, span)
    for i, w in enumerate(want):
        parts = [outs[f"{name}/{i}"] for outs, _ in cards_ranks]
        for g in (parts if i < 2 else [np.concatenate(parts)]):
            np.testing.assert_array_equal(g, w)
    for _, res in cards_ranks:
        st = res[name]
        assert st["backend"] == "nccl"
        assert {c: v["host_B"] for c, v in st["collectives"].items()} == {
            c: 0 for c in ("shapes", "keys", "rows", "columns", "diffs")}
        assert st["launched"]["mtc_step_segments"] == 1
        assert set(st["device_ms"]) >= {"sort", "segments"}


def _payload(name):
    rng = np.random.default_rng(len(name))
    if name == "dna":       # repeat-heavy 2-bit-packed bases, for dzt
        seq = rng.integers(0, 4, 40_000, dtype=np.uint8)
        full = np.concatenate([seq, (3 - seq)[::-1],
                               rng.integers(0, 4, 8_000, dtype=np.uint8)])
        packed = np.zeros(len(full) // 4, np.uint8)
        for i in range(4):
            packed |= full[i::4] << (2 * i)
        return packed.tobytes()
    return {
        "skewed": bytes(rng.choice([0, 0, 0, 0, 1, 2, 65],
                                   40_000).astype(np.uint8)),
        "const": b"\x00" * 30_000,
        "empty": b"",
        "markov": ((rng.integers(-1, 2, 40_000).cumsum() % 16) + 48
                   ).astype(np.uint8).tobytes(),
        "text": b"0\n" * 5000 + b"17G44\n" * 700,
    }[name]


@pytest.mark.parametrize("codec,payload", [
    ("trans", "skewed"), ("trans", "const"), ("trans", "empty"),
    ("trans1", "markov"), ("trans1", "empty"), ("trans2", "text"),
    ("trans2", "const"), ("p2:trans1", "skewed"), ("dzt", "dna")])
def test_rans_kernels_match_plain(dev, codec, payload):
    """Order 0 (trans), 1 (trans1, dzt tokens), 2 (trans2) and 4 (dzt
    literals): the stream coded by the kernels equals the one coded by the
    plain versions, and the kernels decode it."""
    data = _payload(payload)
    want = backend.compress(codec, data, torch.device("cpu"))
    n0 = dict(cuda.launches)
    got = backend.compress(codec, data, dev)
    assert got == want
    assert backend.decompress(codec, got, len(data), dev) == data
    n1 = dict(cuda.launches)
    if data or codec != "trans":     # an empty trans stream has no block
        assert n1["mtc_rans_encode"] > n0.get("mtc_rans_encode", 0)
    if data:
        assert n1["mtc_rans_decode"] > n0.get("mtc_rans_decode", 0)


def random_encode_batch(rng, specs, rows="M", lead=0):
    """A batch for ``rans_encode_blocks`` from ``specs``, one (A, k, T,
    chunked, n, kind) per block: symbols of ``kind`` ("rand": uniform;
    "markov": a walk, so contexts matter; "one": the last symbol only, with
    rows that give it frequency M), random quantized rows with
    zero-frequency symbols (row 1 unused where C > 2); ``rows="any"``
    instead draws every frequency from 0..M, so rows sum to anything.
    ``lead`` bytes before the first block put every block off a 16-byte
    boundary. Returns (syms, freq, desc) as CPU tensors."""
    syms, freqs = [np.zeros(lead, np.uint8)], []
    desc = np.zeros((len(specs), rans.ENC_FIELDS), np.int64)
    s_off, f_off = lead, 0
    for d, (A, k, T, chunked, n, kind) in zip(desc, specs):
        C = A ** k
        if kind == "one":
            sy = np.full(n, A - 1)
        elif kind == "markov":
            sy = rng.integers(-1, 2, n).cumsum() % A
        else:
            sy = rng.integers(0, A, n)
        p = rng.random((C, A)) * (rng.random((C, A)) < 0.7)
        p[:, 0] += 1e-3
        fq = np.stack([rng.multinomial(M, r / r.sum()) for r in p])
        if kind == "one":
            fq[:] = 0
            fq[:, A - 1] = M
        elif rows == "any":
            fq = rng.integers(0, M + 1, (C, A))
        if C > 2:
            fq[1] = 0
        syms.append(sy.astype(np.uint8))
        freqs.append(fq.reshape(-1).astype(np.uint16))
        d[:] = (s_off, f_off, s_off, n, T, A, C, chunked)
        s_off += n
        f_off += C * A
    return (torch.from_numpy(np.concatenate(syms)),
            torch.from_numpy(np.concatenate(freqs)), torch.from_numpy(desc))


ENC_BATCHES = {   # name: [(A, k, T, chunked, n, kind)]
    "order0-B1": [(256, 0, 256, False, 30_000, "rand")],
    # the tail block's lanes from 100 on have no valid step
    "order0-B2-tiers": [(256, 0, 512, False, 65_536, "markov"),
                        (256, 0, 256, False, 100, "rand")],
    "ctx-B5": [(16, 2, 512, True, 60_000, "markov"),
               (4, 4, 256, True, 32_768, "markov"),
               (1, 0, 256, True, 5, "rand"),
               (200, 1, 256, True, 20_000, "rand"),
               (16, 1, 1024, True, 131_072, "markov")],
    "mixed-B2": [(256, 0, 256, False, 0, "rand"),
                 (4, 1, 256, True, 32_000, "markov")],
    # frequency rows of exactly 128 KB: needs the shared-memory opt-in
    "cap-B2": [(16, 3, 256, True, 32_768, "markov"),
               (256, 1, 256, True, 30_000, "rand")],
    # f = M: a step leaves the state as it is, no lane emits
    "one-symbol-B2": [(4, 2, 256, True, 30_000, "one"),
                      (256, 0, 256, False, 30_000, "one")],
}


def assert_same_encoding(got, want, desc):
    """(head, words) pairs equal: every state and count, and each block's
    lane streams up to the sum of its counts."""
    (gh, gw), (wh, ww) = ((h.cpu().numpy(), w.cpu().numpy())
                          for h, w in (got, want))
    np.testing.assert_array_equal(gh, wh)
    for b, d in enumerate(desc.numpy()):
        lo, hi = d[rans.E_WORDS], d[rans.E_WORDS] + int(wh[b, LANES:].sum())
        np.testing.assert_array_equal(gw[lo:hi], ww[lo:hi],
                                      err_msg=f"block {b}")


@pytest.mark.parametrize("rows,lead", [("M", 0), ("any", 0), ("M", 3)])
@pytest.mark.parametrize("name", list(ENC_BATCHES))
def test_rans_encode_blocks_kernel_matches_plain(dev, name, rows, lead):
    """Every block of a batch in one launch == the plain version, states,
    counts and words: order 0 and orders 1 to 4, both lane layouts, tiers
    256 to 1024, A from 1 to 256, tables at the 128 KB cap, n = 0, lanes
    with no valid step, a one-symbol block, rows that do not sum to M,
    blocks off a 16-byte boundary."""
    syms, freq, desc = random_encode_batch(
        np.random.default_rng(len(name) + lead), ENC_BATCHES[name], rows, lead)
    want = rans_encode_blocks(syms, freq, desc)
    n0 = cuda.launches["mtc_rans_encode"]
    got = rans_encode_blocks(syms.to(dev), freq.to(dev), desc)
    assert cuda.launches["mtc_rans_encode"] == n0 + 1
    assert_same_encoding(got, want, desc)


def test_rans_encode_then_decode_blocks_gives_symbols_back(dev):
    """Blocks of both coders in one encode launch, then one decode launch:
    the symbols come back."""
    rng = np.random.default_rng(3)
    parts = [rng.choice([3, 7, 7, 7, 9], 40_000).astype(np.uint8)]
    blocks = [device_rans.Block(
        40_000, 512, 256, 1, False, device_rans.quantize_freqs(
            np.bincount(parts[0], minlength=256)))]
    for A, k, n in ((16, 2, 50_000), (4, 4, 32_768), (1, 2, 700),
                    (200, 2, 20_000), (16, 3, 0)):
        parts.append((rng.integers(-1, 2, n).cumsum() % A).astype(np.uint8))
        blocks.append(device_ctx_rans._model(parts[-1], A, k))
    n0 = dict(cuda.launches)
    coded = device_rans.encode_blocks(np.concatenate(parts), blocks, dev)
    got = device_rans.decode_blocks(coded, dev)
    assert cuda.launches["mtc_rans_encode"] == n0.get("mtc_rans_encode",
                                                      0) + 1
    assert cuda.launches["mtc_rans_decode"] == n0.get("mtc_rans_decode",
                                                      0) + 1
    for g, w in zip(got, parts):
        np.testing.assert_array_equal(g, w)


def test_rans_decode_kernel_matches_plain_corrupt_words(dev):
    """Random states and words (a corrupt stream): the clamped word reads
    and the u32 wraparound agree, on the valid steps of a block of n
    symbols and on its pad steps."""
    rng = np.random.default_rng(5)
    A, C, T, W, n = 4, 16, 512, 64, 60_000
    freq = np.tile(np.array([1000, 96, 2000, 1000], np.uint32), C)
    cum = np.tile(np.array([0, 1000, 1096, 3096], np.uint32), C)
    slot = np.tile(np.repeat(np.arange(A, dtype=np.uint8), freq[:A]), C)
    args = [torch.from_numpy(a) for a in (
        rng.integers(0, 2**32, LANES, dtype=np.uint32),
        rng.integers(0, 2**16, (W, LANES)).astype(np.uint16),
        (np.arange(T * LANES) < n).reshape(T, LANES), freq, cum, slot)]
    want = rans_decode(*args, A, C).numpy()
    got = rans_decode(*(a.to(dev) for a in args), A, C).cpu().numpy()
    np.testing.assert_array_equal(got, want)


def random_batch(rng, specs, corrupt=False):
    """A batch for ``rans_decode_blocks`` from ``specs``, one (A, C, T,
    chunked, n) per block: random quantized rows (zero-frequency symbols in
    every row; with C > 2 row 1 is unused and row 2 has one symbol), random
    states, random lane streams of 0..T/4 words per lane. Not a coded stream:
    both versions must decode any input alike. ``corrupt`` gives every lane
    too few words, so lanes run past their streams. Returns (head, words,
    freq, desc, out_size) as CPU tensors."""
    heads, words, freqs = [], [], []
    desc = np.zeros((len(specs), rans.DESC_FIELDS), np.int64)
    w_off = f_off = o_off = 0
    for d, (A, C, T, chunked, n) in zip(desc, specs):
        p = rng.random((C, A)) * (rng.random((C, A)) < 0.7)
        p[:, 0] += 1e-3
        fq = np.stack([rng.multinomial(M, r / r.sum()) for r in p])
        if C > 2:
            fq[1] = 0
            fq[2] = 0
            fq[2, A - 1] = M
        counts = rng.integers(0, (4 if corrupt else T // 4) + 1, LANES)
        heads.append(np.concatenate([
            rng.integers(0, 2**32, LANES, dtype=np.uint64), counts]
        ).astype(np.uint32))
        words.append(rng.integers(0, 2**16, int(counts.sum())
                                  ).astype(np.uint16))
        freqs.append(fq.reshape(-1).astype(np.uint16))
        d[:] = (w_off, counts.sum(), f_off, o_off, n, T,
                device_rans._wtier(max(1, int(counts.max()))), A, C,
                chunked)
        w_off += int(counts.sum())
        f_off += C * A
        o_off += T * LANES
    return (torch.from_numpy(np.stack(heads)),
            torch.from_numpy(np.concatenate(words)),
            torch.from_numpy(np.concatenate(freqs)),
            torch.from_numpy(desc), o_off)


BATCHES = {   # name: [(A, C, T, chunked, n)]
    "order0-B1": [(256, 1, 256, False, 30_000)],
    "order0-B2-tiers": [(256, 1, 512, False, 65_536),
                        (256, 1, 256, False, 100)],
    "ctx-B5": [(16, 256, 512, True, 60_000), (4, 256, 256, True, 32_768),
               (1, 1, 256, True, 5), (200, 200, 256, True, 20_000),
               (16, 16, 1024, True, 131_072)],
    "mixed-B2": [(256, 1, 256, False, 0), (4, 4, 256, True, 32_000)],
    # frequency rows of exactly 128 KB: needs the shared-memory opt-in
    "cap-B2": [(16, 4096, 256, True, 32_768), (256, 256, 256, True, 30_000)],
}


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("name", list(BATCHES))
def test_rans_decode_blocks_kernel_matches_plain(dev, name, corrupt):
    """Every block of a batch in one launch == the plain version, every
    slot of every grid: order 0 and contexts, both lane layouts, tiers 256
    to 1024, slot table and binary search, unused rows, lanes that run out
    of words."""
    batch = random_batch(np.random.default_rng(len(name) + corrupt),
                         BATCHES[name], corrupt)
    want = rans_decode_blocks(*batch).numpy()
    n0 = cuda.launches["mtc_rans_decode"]
    got = rans_decode_blocks(*(a.to(dev) for a in batch[:3]), *batch[3:])
    assert cuda.launches["mtc_rans_decode"] == n0 + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("codec", ["trans", "trans2", "dzt"])
def test_rans_multiblock_stream_is_one_launch(dev, codec, monkeypatch):
    """A stream of several blocks (BLOCK shrunk): coded alike on the card
    and the CPU, coded by one launch and decoded by one launch (two each
    for dzt's two planes)."""
    monkeypatch.setattr(device_rans, "BLOCK", 1 << 15)
    monkeypatch.setattr(device_ctx_rans, "BLOCK", 1 << 15)
    data = (_payload("dna") if codec == "dzt" else
            _payload("markov") + _payload("text") + _payload("skewed"))
    planes = 2 if codec == "dzt" else 1
    n0 = cuda.launches["mtc_rans_encode"]
    blob = backend.compress(codec, data, dev)
    assert cuda.launches["mtc_rans_encode"] - n0 == planes
    assert blob == backend.compress(codec, data, torch.device("cpu"))
    n0 = cuda.launches["mtc_rans_decode"]
    assert backend.decompress(codec, blob, len(data), dev) == data
    assert cuda.launches["mtc_rans_decode"] - n0 == planes


def test_verify_kernel_matches_plain(dev):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(0, 2**32, (1000, 7), dtype=np.uint32))
    b = torch.from_numpy(rng.integers(0, 2**32, (1000, 7), dtype=np.uint32))
    n0 = cuda.launches["mtc_popcount_verify"]
    got = popcount_verify(a.to(dev), b.to(dev)).cpu().numpy()
    assert cuda.launches["mtc_popcount_verify"] == n0 + 1
    np.testing.assert_array_equal(got, popcount_verify(a, b).numpy())


def test_kernel_bench_tool_at_an_eighth(dev, tmp_path):
    """tools/kernel_bench_torch.py at scale 8: every row, each named kernel
    launched once by its entry, cold and warm times, no share above 1.05
    (a count or a timing at fault would show here)."""
    spec = importlib.util.spec_from_file_location(
        "kernel_bench_torch", os.path.join(os.path.dirname(__file__), "..",
                                           "tools", "kernel_bench_torch.py"))
    tool = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "kernels.json"
    assert tool.main(["--scale", "8", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert list(rows) == list(tool.ROWS)
    for name, r in rows.items():
        assert r["launches"] == {k: 1 for k in r["kernels"]}, name
        assert r["ms_cold"] > 0 and r["ms_warm"] > 0, name
        assert r["share_cold"] <= 1.05, (name, r["share_cold"])


def _genome_fastq(path, rng, n, L=100):
    """n reads of a random 4 kb genome, both strands, 1% errors, as FASTQ;
    returns the sequence lines."""
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    reads = genome[rng.integers(0, 4000 - L, n)[:, None] + np.arange(L)]
    err = rng.random((n, L)) < 0.01
    reads = np.where(err, (reads + 1) % 4, reads).astype(np.uint8)
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    lines = [bytes(r) for r in np.frombuffer(b"ACGT", np.uint8)[reads]]
    with open(path, "wb") as f:
        for i, r in enumerate(lines):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * L))
    return lines


def _cuda_equals_cpu(dev, tmp_path, cfg, fq, fq2=None):
    """Archive on dev == archive on the CPU; returns the cuda archive and
    the launch counts of its compress."""
    a, b = str(tmp_path / "cuda.mtc"), str(tmp_path / "cpu.mtc")
    n0 = dict(cuda.launches)
    compressor.compress(fq, a, cfg, reads_path2=fq2, device=dev)
    n1 = dict(cuda.launches)
    compressor.compress(fq, b, cfg, reads_path2=fq2, device="cpu")
    assert open(a, "rb").read() == open(b, "rb").read()
    return a, {k: v - n0.get(k, 0) for k, v in n1.items()}


@pytest.mark.parametrize("name", [e["name"]
                                  for e in configs_torch.load_configs()])
def test_configuration_archive_on_cuda_equals_cpu(dev, tmp_path, name):
    """Each entry of CONFIGS_torch.json at 20,000 reads: the card's archive
    is the CPU's, the read minimizer, the contig sketch and the vote each
    launch, and the card's decompress gives the reads back."""
    entry = configs_torch.config_entry(name)
    fq = configs_torch.make_input(entry, str(tmp_path), 20_000)
    arc, launched = _cuda_equals_cpu(
        dev, tmp_path, CompressorConfig(**entry["settings"]), fq)
    for k in ("mtc_sketch_reads", "mtc_sketch_windowed",
              "mtc_consensus_vote"):
        assert launched.get(k, 0) > 0, k
    out = str(tmp_path / "d.reads")
    compressor.decompress(arc, out, device=dev)
    plain = configs_torch.input_name(dict(entry, gzip=False), 20_000)
    want = open(tmp_path / plain, "rb").read().splitlines()[1::4]
    assert sorted(open(out, "rb").read().splitlines()) == sorted(want)


def test_order_roundtrip_on_cuda(dev, tmp_path):
    fq = str(tmp_path / "in.fastq")
    lines = _genome_fastq(fq, np.random.default_rng(11), 800)
    arc, launched = _cuda_equals_cpu(dev, tmp_path,
                                     CompressorConfig(order=True), fq)
    assert launched["mtc_sketch_reads"] > 0
    assert launched["mtc_consensus_vote"] > 0
    out = str(tmp_path / "o.reads")
    compressor.decompress(arc, out)
    assert open(out, "rb").read().splitlines() == lines


def test_two_rank_roundtrip_on_cuda(dev, tmp_path):
    """Two ranks on one card (gloo): the archive equals the single-process
    cuda archive, each rank launched the read minimizer, the vote and the
    contig sketch, and the sharded decode equals the single-process one."""
    from bench import make_dataset
    worker = _load_helper("_torch_dist_worker")
    job_results, run_group = worker.job_results, worker.run_group
    fq = str(tmp_path / "in.fastq")
    make_dataset(fq, 20_000)
    one = str(tmp_path / "one.mtc")
    compressor.compress(fq, one, device=dev)
    compressor.decompress(one, one + ".reads")
    res = run_group(str(tmp_path), "g", 2, [dict(
        op="compress", fq=fq, cfg={}, out=str(tmp_path / "two.mtc"),
        decode=str(tmp_path / "two.reads"), device="cuda:0")],
        env=_cards(1))
    for r in range(2):
        launched = job_results(res, r)[0]["launched"]
        for k in ("mtc_sketch_reads", "mtc_consensus_vote",
                  "mtc_sketch_windowed"):
            assert launched.get(k, 0) > 0, (r, launched)
    assert (open(tmp_path / "two.mtc", "rb").read()
            == open(one, "rb").read())
    assert (open(tmp_path / "two.reads", "rb").read()
            == open(one + ".reads", "rb").read())


def test_pe_roundtrip_on_cuda(dev, tmp_path):
    rng = np.random.default_rng(12)
    fq1, fq2 = str(tmp_path / "m1.fastq"), str(tmp_path / "m2.fastq")
    l1, l2 = _genome_fastq(fq1, rng, 500), _genome_fastq(fq2, rng, 500)
    arc, launched = _cuda_equals_cpu(dev, tmp_path, CompressorConfig(), fq1,
                                     fq2)
    assert launched["mtc_sketch_reads"] > 0
    o1, o2 = str(tmp_path / "o1.reads"), str(tmp_path / "o2.reads")
    compressor.decompress(arc, o1, o2)
    got = sorted(zip(open(o1, "rb").read().splitlines(),
                     open(o2, "rb").read().splitlines()))
    assert got == sorted(zip(l1, l2))


# ---- the crossings between host and card (ops/cuda.py) ---------------------

def test_accounting_counts_h2d_d2h_and_pinned_copies(dev):
    cuda.reset_device_seconds()
    a = np.arange(3000, dtype=np.int32)
    x = cuda.to_device(a, dev)
    u = torch.arange(1000, dtype=torch.int64)
    y = cuda.to_device(u, dev)
    assert cuda.device_bytes() == 12_000 + 8_000
    np.testing.assert_array_equal(cuda.to_host(x).numpy(), a)
    assert cuda.device_bytes() == 2 * 12_000 + 8_000
    pinned = torch.empty(1000, dtype=torch.int64, pin_memory=True)
    pinned.copy_(u)
    z = cuda.to_device(pinned, dev, non_blocking=True)
    out = torch.zeros(1000, dtype=torch.int64, pin_memory=True)
    assert cuda.to_host(z + y, out) is out
    assert torch.equal(out, 2 * u)
    assert cuda.device_bytes() == 2 * 12_000 + 3 * 8_000
    assert cuda.to_device(x, dev) is x and cuda.to_host(out) is out
    assert cuda.device_bytes() == 2 * 12_000 + 3 * 8_000
    cuda.reset_device_seconds()


def test_accounting_download_after_a_launch_adds_seconds(dev):
    rng = np.random.default_rng(21)
    codes = torch.from_numpy(_reads_store(rng, 1 << 16, 100)).to(dev)
    rids = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    out = sketch_reads_device(codes, rids, 31)
    cuda.reset_device_seconds()
    cuda.to_host(out)
    assert cuda.device_seconds() > 0
    assert cuda.device_bytes() == out.numel() * 4
    # the cluster rounds' entry: the int32 rids up, the three words down
    cuda.reset_device_seconds()
    sketch_reads_flat(codes, rng.integers(0, 1 << 16, 5000), 31)
    assert cuda.device_bytes() == 5000 * (4 + 12)
    cuda.reset_device_seconds()


def test_accounting_compress_100k_by_stage(dev, tmp_path):
    """The read store's bytes in the upload stage, the cluster and merge
    kernels' crossings in theirs, no entropy crossing with codec="auto",
    and no byte outside a stage."""
    from bench import make_dataset
    fq, arc = str(tmp_path / "in.fastq"), str(tmp_path / "out.mtc")
    make_dataset(fq, 100_000)
    cuda.reset_device_seconds()
    s = compressor.compress(fq, arc, device=dev)
    assert s["device_upload_bytes"] == 100_000 * 100
    assert s["device_cluster_bytes"] > 0 and s["device_merge_bytes"] > 0
    assert "device_entropy_bytes" not in s and "device_entropy_s" not in s
    assert sum(v for k, v in s.items() if k.startswith("device_")
               and k.endswith("_bytes")) == cuda.device_bytes()
    cuda.reset_device_seconds()
