"""The port's sketch functions (minicom_tpu_torch.ops.sketch), in their plain
PyTorch versions on the CPU, against the JAX package: the XLA programs, the
Pallas contig-sketch kernel in interpret mode, and the host C++ twins. All
comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minicom_tpu.ops import sketch as jsk
from minicom_tpu.ops.pallas_sketch import sketch_windowed_pallas_compact32
from minicom_tpu_torch import native
from minicom_tpu_torch.ops import sketch as tsk
from minicom_tpu_torch.pipeline.merge import _batch_m, _lmax_bucket


def test_mix32_matches_reference(rng):
    hi = rng.integers(0, 1 << 32, 512, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, 512, dtype=np.uint32)
    hi[:4] = [0, 0xFFFFFFFF, 0xFFFFFFFF, 1]
    lo[:4] = [0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    want = np.asarray(jsk.mix32(jnp.asarray(hi), jnp.asarray(lo)))
    got = tsk.mix32(torch.from_numpy(hi.astype(np.int64)),
                    torch.from_numpy(lo.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("L", [64, 100, 150])
@pytest.mark.parametrize("k", [4, 17, 30, 31])
def test_sketch_reads_matches_reference(rng, k, L):
    N = 400
    codes = rng.integers(0, 4, (N, L), dtype=np.uint8)
    codes[:6] = np.tile(np.array([0, 3], np.uint8), L // 2)  # palindromic
    codes[6:8] = 0                                           # repeats
    rids = rng.integers(0, N, 700)
    rids[:8] = np.arange(8)
    got = tsk.sketch_reads_gather(torch.from_numpy(codes),
                                  torch.from_numpy(rids), k).numpy()
    want = np.asarray(jsk.sketch_reads_dyn_gather_packed(
        jnp.asarray(codes), jnp.asarray(rids.astype(np.int32)), k))
    np.testing.assert_array_equal(got, want)
    hi, lo, pos, z = native.sketch_reads_host(codes, rids, k)
    np.testing.assert_array_equal(
        got, np.stack([hi, lo, (pos.astype(np.uint32) << 1) | z]))
    if k == 30:   # all-palindromic rows get the all-zero record
        assert not got[:, :6].any()


def _reads_case(rng, N, L, n):
    """N reads of L bases (palindromic rows 0-5, one-base rows 6-9) and n
    rids with repeats, the special rows first."""
    codes = rng.integers(0, 4, (N, L), dtype=np.uint8)
    codes[:6] = np.resize(np.array([0, 3], np.uint8), L)
    codes[6:8] = 0
    codes[8:10] = 3
    rids = rng.integers(0, N, n)
    rids[:min(n, 10)] = np.arange(min(n, 10))
    return codes, rids


def _all_entries_equal(codes, rids, k):
    """sketch_reads_flat == sketch_reads_gather == the JAX program == the
    host twin; returns the result."""
    got = tsk.sketch_reads_flat(torch.from_numpy(codes), rids, k)
    assert got.dtype == np.uint32 and got.shape == (3, len(rids))
    gather = tsk.sketch_reads_gather(torch.from_numpy(codes),
                                     torch.from_numpy(rids), k).numpy()
    np.testing.assert_array_equal(got, gather)
    want = np.asarray(jsk.sketch_reads_dyn_gather_packed(
        jnp.asarray(codes), jnp.asarray(rids.astype(np.int32)), k))
    np.testing.assert_array_equal(got, want)
    hi, lo, pos, z = native.sketch_reads_host(codes, rids, k)
    np.testing.assert_array_equal(
        got, np.stack([hi, lo, (pos.astype(np.uint32) << 1) | z]))
    return got


@pytest.mark.parametrize("L", [36, 101, 150, 256])
@pytest.mark.parametrize("k", [4, 17, 24, 30, 31])
def test_sketch_reads_flat_matches_reference(rng, k, L):
    codes, rids = _reads_case(rng, 200, L, 300)
    got = _all_entries_equal(codes, rids, k)
    if k % 2 == 0:   # all-palindromic rows get the all-zero record
        assert not got[:, :6].any()
    # a one-base row: every k-mer the same, the first start wins
    assert (got[2, 6:10] >> 1 == k - 1).all()


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("k", [4, 31])
def test_sketch_reads_flat_empty_and_single(rng, n, k):
    codes, rids = _reads_case(rng, 40, 101, n)
    _all_entries_equal(codes, rids.astype(np.int64), k)


@pytest.mark.parametrize("case", ["low", "high", "float", "2d", "k0", "k32",
                                  "low_many", "high_many"])
def test_sketch_reads_checks_on_the_host(case):
    """Bad rids and k raise before the read store is touched: a store on
    the meta device has no data to read. The tensor entry raises alike.
    "_many": as many rids as take the check on every core."""
    codes = torch.empty((4, 10), dtype=torch.uint8, device="meta")
    rids, k, err = np.array([0, 3]), 5, IndexError
    if case.endswith("_many"):
        rids = np.resize(np.arange(4), tsk.HOST_PARALLEL)
        rids[-1] = -1 if case == "low_many" else 4
    elif case == "low":
        rids = np.array([0, -1])
    elif case == "high":
        rids = np.array([4, 0])
    elif case == "float":
        rids, err = np.array([0.0, 1.0]), ValueError
    elif case == "2d":
        rids, err = np.zeros((1, 2), np.int64), ValueError
    else:
        k, err = (0 if case == "k0" else 32), ValueError
    with pytest.raises(err):
        tsk.sketch_reads_flat(codes, rids, k)
    if rids.dtype == np.int64 and rids.ndim == 1:   # the tensor entry
        with pytest.raises(err):
            tsk.sketch_reads_gather(torch.zeros((4, 10), dtype=torch.uint8),
                                    torch.from_numpy(rids), k)


def test_sketch_reads_flat_many_rids(rng):
    """As many rids as take the host's checks on every core: the flat
    entry == the host twin."""
    codes, _ = _reads_case(rng, 50, 36, 0)
    rids = rng.integers(0, 50, tsk.HOST_PARALLEL).astype(np.int32)
    got = tsk.sketch_reads_flat(torch.from_numpy(codes), rids, 17)
    hi, lo, pos, z = native.sketch_reads_host(codes, rids.astype(np.int64),
                                              17)
    np.testing.assert_array_equal(
        got, np.stack([hi, lo, (pos.astype(np.uint32) << 1) | z]))


@pytest.mark.parametrize("N,L", [(1 << 31, 10), (4, 257)])
def test_sketch_reads_store_limits_on_the_host(N, L):
    """A store the kernel cannot take (more rows than int32 rids reach, or
    reads longer than it stages) raises before anything touches it."""
    codes = torch.empty((N, L), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="the kernel takes at most"):
        tsk.sketch_reads_flat(codes, np.array([0, 3]), 5)


def _strip_cut(t, g, S, k, L):
    """csrc/sketch.cu::strip_cut: the first end base of lane t's strip."""
    if t == 0:
        return k - 1
    if t == g:
        return L
    return min(max((k - 1 + t * S // g + 8) & ~15, k), L)


def _strips(codes, rids, k, g):
    """The kernel's split of the read minimizer, in torch: lane t of a read
    ranks the k-mers ending at bases [cut(t), cut(t + 1)), the ends cut
    near t / g of the way at multiples of 16, keeping its first minimum
    (rank, start); the g lanes combine by xor butterflies of the (rank,
    start) minimum (a lane with no k-mers holds the largest key); the
    winner's k-mer and strand come from its start."""
    rows = torch.from_numpy(codes)[torch.from_numpy(rids)].to(torch.int64)
    n, L = rows.shape
    S = L - k + 1
    h, canon, strand, pal = tsk._kmers(rows, k)
    h = torch.where(pal, tsk.U32_MAX, h)
    rank = torch.full((n, g), 1 << 32, dtype=torch.int64)
    start = torch.full((n, g), 1 << 32, dtype=torch.int64)
    for t in range(g):
        b0 = _strip_cut(t, g, S, k, L) - k + 1
        e0 = _strip_cut(t + 1, g, S, k, L) - k + 1
        if b0 >= e0:
            continue
        part = h[:, b0:e0]
        j = part.argmin(dim=1)        # the first minimum of the strip
        rank[:, t] = part.gather(1, j[:, None])[:, 0]
        start[:, t] = j + b0
    for d in (1, 2)[:g.bit_length() - 1]:
        r2, s2 = rank[:, torch.arange(g) ^ d], start[:, torch.arange(g) ^ d]
        take = (r2 < rank) | ((r2 == rank) & (s2 < start))
        rank, start = torch.where(take, r2, rank), torch.where(take, s2, start)
    rank, sp = rank[:, 0], start[:, 0]
    live = rank < tsk.U32_MAX
    sp = torch.where(live, sp, 0)
    best = canon.gather(1, sp[:, None])[:, 0]
    meta = ((sp + k - 1) << 1) | strand.gather(1, sp[:, None])[:, 0]
    out = torch.stack([best >> 32, best & tsk.U32_MAX, meta])
    return torch.where(live, out, 0).to(torch.uint32).numpy()


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("L,k", [(100, 31), (101, 24), (36, 30), (150, 4),
                                 (33, 31), (256, 17), (40, 24)])
def test_strip_split_and_combine_equals_plain(rng, g, L, k):
    """Starts not divisible by g (S = 70, 78, 7, 147, 3, 240, 17; some
    strips empty), rows whose equal ranks fall in several strips (one base
    throughout, or a period of 4), palindromes: the strips cover every
    start once, and their first minima combined by shuffles keep the first
    start of the read's minimum."""
    S = L - k + 1
    cuts = [_strip_cut(t, g, S, k, L) for t in range(g + 1)]
    assert cuts[0] == k - 1 and cuts[-1] == L
    assert all(a <= b for a, b in zip(cuts, cuts[1:]))
    assert all(c % 16 == 0 or c in (k, L) for c in cuts[1:])
    codes, rids = _reads_case(rng, 120, L, 200)
    codes[10:14] = np.resize(np.array([0, 1, 2, 3], np.uint8), L)
    rids[10:14] = np.arange(10, 14)
    want = tsk._sketch_reads_plain(torch.from_numpy(codes),
                                   torch.from_numpy(rids), k).numpy()
    np.testing.assert_array_equal(_strips(codes, rids, k, g), want)


@pytest.mark.parametrize("Lmax", [128, 512, 2048])
# (k, w) of the main path's cells, then of CONFIGS_torch.json's entries
# (the reference's documented command lines and the 256 bp cap's w = 97)
@pytest.mark.parametrize("k,w", [(31, 19), (17, 11), (4, 3), (17, 3),
                                 (17, 20), (23, 5), (25, 15), (25, 20),
                                 (31, 97)])
def test_sketch_windowed_matches_reference(rng, Lmax, k, w):
    rows = 16
    ref = rng.integers(0, 4, 4 * Lmax + 1024, dtype=np.uint8)
    ref[100:300] = np.tile(np.array([0, 3], np.uint8), 100)  # palindromes
    ref[400:700] = 2                                          # long repeat
    lens = rng.integers(k, Lmax + 1, rows).astype(np.int32)
    lens[:6] = [Lmax, k - 1, 1, k, Lmax, min(200, Lmax)]
    lens[-3:] = 0                                   # zero-length pad rows
    starts = rng.integers(0, len(ref) - Lmax, rows).astype(np.int64)
    starts[4:6] = [100, 400]
    starts[-3:] = 0
    we = min(w, Lmax - k + 1)
    sl = jnp.asarray(np.stack([starts, lens]).astype(np.int32))
    codes, ln = jsk.gather_contig_rows(jnp.asarray(ref), sl, Lmax)

    # the merge stage's slot count against the XLA program and the host
    # twin; a smaller one (more saturated rows) against the Pallas kernel,
    # whose interpret-mode compile time grows with the slot count
    for mb, ref_fn in ((24, lambda *a: sketch_windowed_pallas_compact32(
                            *a, interpret=True)),
                       (_batch_m(Lmax, k, w, 128),
                        jsk.sketch_windowed_compact32)):
        key, meta, nv = (x.numpy() for x in tsk.sketch_windowed_compact32(
            torch.from_numpy(ref), torch.from_numpy(starts),
            torch.from_numpy(lens), Lmax, k, we, mb))
        v = np.arange(mb)[None, :] < nv[:, None]
        buf = np.asarray(ref_fn(codes, ln, k, we, mb))
        cm = rows * mb
        np.testing.assert_array_equal(nv, buf[2 * cm:].view(np.int32))
        np.testing.assert_array_equal(key[v], buf[:cm].reshape(rows, mb)[v])
        np.testing.assert_array_equal(
            meta[v], buf[cm:2 * cm].view(np.int32).reshape(rows, mb)[v])
    nk, nm, nnv = native.sketch_windowed_host(
        ref, starts, lens, k, np.full(rows, we, np.int32),
        np.full(rows, mb, np.int32), mb)
    np.testing.assert_array_equal(nv, nnv)
    np.testing.assert_array_equal(key[v], nk[v])
    np.testing.assert_array_equal(meta[v], nm[v])
    assert (nv[lens < k] == 0).all()


def test_wrappers_validate_inputs():
    codes = torch.zeros((4, 10), dtype=torch.uint8)
    with pytest.raises(IndexError):
        tsk.sketch_reads_gather(codes, torch.tensor([0, 4]), 5)
    with pytest.raises(ValueError):
        tsk.sketch_reads_gather(codes, torch.tensor([0], dtype=torch.int32), 5)
    ref = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(IndexError):   # row runs past the stream
        tsk.sketch_windowed_compact32(
            ref, torch.tensor([90]), torch.tensor([20], dtype=torch.int32),
            128, 17, 11, 8)
    for st, ln in (([90], [20]), ([-1], [5]), ([0], [-3])):
        with pytest.raises(IndexError):
            tsk.sketch_windowed_flat(ref, np.array(st), np.array(ln),
                                     np.array([8]), 17, 11)
    with pytest.raises(ValueError):   # a row with no slots
        tsk.sketch_windowed_flat(ref, np.array([0]), np.array([20]),
                                 np.array([0]), 17, 11)


def _mixed_plan(rng, k):
    """Contig rows of every rung up to 2048 in plan order (sorted by
    length) in one stream: empty rows, rows shorter than k, a palindromic
    and a long-repeat row, rows long enough to fill their slots."""
    ref = rng.integers(0, 4, 40_000, dtype=np.uint8)
    ref[100:700] = np.tile(np.array([0, 3], np.uint8), 300)
    ref[1000:3000] = 2
    lens = np.sort(np.r_[rng.integers(0, 129, 24), rng.integers(129, 513, 8),
                         rng.integers(513, 2049, 4), [0, 1, k - 1, 600, 2000,
                                                      2048]])
    starts = rng.integers(0, len(ref) - 2048, len(lens))
    starts[lens == 600] = 100
    starts[lens == 2000] = 1000
    return ref, starts.astype(np.int64), lens.astype(np.int64)


@pytest.mark.parametrize("k,w,cap", [(31, 19, 128), (17, 40, 16),
                                     (31, 300, 128), (4, 3, 24)])
def test_sketch_windowed_flat_matches_chunks_and_reference(rng, k, w, cap):
    """The batched plain version (every rung's rows in one call, each row
    with its rung's mb) equals, chunk by chunk, the dense plain version,
    the JAX package's XLA program over ``gather_contig_rows`` and the host
    twin, and on the first chunk the Pallas kernel in interpret mode."""
    ref, starts, lens = _mixed_plan(rng, k)
    rung = np.array([_lmax_bucket(max(int(n), k + 1)) for n in lens])
    mb = np.array([_batch_m(int(r), k, w, cap) for r in rung])
    key, meta, nv = tsk.sketch_windowed_flat(torch.from_numpy(ref), starts,
                                             lens, mb, k, w)
    assert (nv[lens < k] == 0).all()
    if (k, w) == (31, 19):
        assert (nv == mb).any()        # saturated rows
    cuts = np.r_[0, np.flatnonzero(np.diff(rung)) + 1, len(lens)]
    got, want = [key, meta, nv], [[], [], []]
    for i, j in zip(cuts[:-1], cuts[1:]):
        Lmax, m = int(rung[i]), int(mb[i])
        we = min(w, Lmax - k + 1)
        dk, dm, dn = (x.numpy() for x in tsk.sketch_windowed_compact32(
            torch.from_numpy(ref), torch.from_numpy(starts[i:j]),
            torch.from_numpy(lens[i:j].astype(np.int32)), Lmax, k, we, m))
        v = np.arange(m)[None, :] < dn[:, None]
        for acc, x in zip(want, (dk[v], dm[v], dn)):
            acc.append(x)
        # the Pallas kernel takes rows in blocks of 8: zero-length pad rows
        pad = -(j - i) % 8 if i == 0 else 0
        sl = np.zeros((2, j - i + pad), np.int32)
        sl[:, :j - i] = np.stack([starts[i:j], lens[i:j]])
        codes, ln = jsk.gather_contig_rows(jnp.asarray(ref), jnp.asarray(sl),
                                           Lmax)
        fns = [jsk.sketch_windowed_compact32]
        if i == 0:
            fns.append(lambda *a: sketch_windowed_pallas_compact32(
                *a, interpret=True))
        for fn in fns:
            buf = np.asarray(fn(codes, ln, k, we, m))
            cm = sl.shape[1] * m
            bk = buf[:cm].reshape(-1, m)[:j - i]
            bm = buf[cm:2 * cm].view(np.int32).reshape(-1, m)[:j - i]
            np.testing.assert_array_equal(
                dn, buf[2 * cm:].view(np.int32)[:j - i])
            np.testing.assert_array_equal(dk[v], bk[v])
            np.testing.assert_array_equal(dm[v], bm[v])
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, np.concatenate(x))
    hk, hm, hn = native.sketch_windowed_host(
        ref, starts, lens, k, np.minimum(w, rung - k + 1).astype(np.int32),
        mb.astype(np.int32), int(mb.max()))
    hv = np.arange(hk.shape[1])[None, :] < hn[:, None]
    np.testing.assert_array_equal(nv, hn)
    np.testing.assert_array_equal(key, hk[hv])
    np.testing.assert_array_equal(meta, hm[hv])
