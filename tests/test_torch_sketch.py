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


@pytest.mark.parametrize("Lmax", [128, 512, 2048])
@pytest.mark.parametrize("k,w", [(31, 19), (17, 11), (4, 3)])
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
